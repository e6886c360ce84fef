"""Placement of batches and parameters on a mesh (the JAX package's
``parallel/sharding.py``): a batch is sharded by slicing this rank's part
of its leading dimension over "data"; parameters are replicated by
broadcasting them from the mesh's first rank."""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from .collectives import broadcast
from .mesh import DATA_AXIS, Mesh


def tree_map(fn, tree):
    """``fn`` on every tensor of nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


class BatchSharding(NamedTuple):
    """The leading dimension split over ``axis`` in equal parts."""

    mesh: Mesh
    axis: str = DATA_AXIS

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        n = self.mesh.axis_size(self.axis)
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} not divisible by the "
                             f"{n} ranks of {self.axis!r}")
        b = t.shape[0] // n
        return t.narrow(0, self.mesh.axis_index(self.axis) * b, b)


class Replicated(NamedTuple):
    """The same value on every rank of the mesh: rank ``ranks[0, 0]``'s."""

    mesh: Mesh

    def place(self, t: torch.Tensor) -> torch.Tensor:
        if self.mesh.group_all is None:
            return t
        return broadcast(t, int(self.mesh.ranks[0, 0]), self.mesh.group_all)


def batch_sharding(mesh: Mesh, ndim: int = 4) -> BatchSharding:
    """Shard the leading (batch) dimension over "data"; ``ndim`` is JAX's
    argument (the rank of the arrays) and changes nothing here."""
    del ndim
    return BatchSharding(mesh)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)


def shard_batch(mesh: Mesh, batch: Any) -> Any:
    """This rank's part of every tensor of a (nested) batch."""
    spec = batch_sharding(mesh)
    return tree_map(spec.shard, batch)


def shard_params(mesh: Mesh, params: Any) -> Any:
    """Replicate parameters across the mesh: every tensor of a tree, or
    every parameter and buffer of a module, broadcast in place from the
    mesh's first rank."""
    rep = replicated(mesh)
    if isinstance(params, nn.Module):
        with torch.no_grad():
            for t in list(params.parameters()) + list(params.buffers()):
                rep.place(t)
        return params
    return tree_map(lambda t: rep.place(t.clone()), params)
