"""Data-parallel serving (the JAX package's ``parallel/serving.py``): every
rank runs the whole serving forward (the int8 oracle, the PSRP graph on
K1-K3, the packed graph, the float model) on its part of the batch, and
the outputs are gathered in batch order. Inference needs no other
collective; the parameters are replicated."""

from __future__ import annotations

import torch

from .collectives import all_gather_cat
from .mesh import DATA_AXIS, Mesh
from .sharding import BatchSharding


def dp_serve(forward, mesh: Mesh, axis: str = DATA_AXIS):
    """-> ``fn(params, images)``: ``forward(params, shard)`` on this rank's
    shard of ``images`` (the same batch on every rank, its size divisible
    by the ranks of ``axis``), the outputs of every rank concatenated in
    batch order, on every rank."""

    def fn(params, images: torch.Tensor) -> torch.Tensor:
        out = forward(params, shard_batch(mesh, images, axis))
        if mesh.axis_size(axis) == 1:
            return out
        return all_gather_cat(out, mesh.group(axis), dim=0)

    return fn


def shard_batch(mesh: Mesh, images: torch.Tensor,
                axis: str = DATA_AXIS) -> torch.Tensor:
    """This rank's part of ``images``' leading dimension over ``axis``."""
    return BatchSharding(mesh, axis).shard(images)
