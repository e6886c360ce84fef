"""Spatial (halo-exchange) sharding of the H axis over the mesh's "space"
axis, and single-device sliding-window inference (the JAX package's
``parallel/halo.py``).

Under ``spatial_partitioning`` every conv of the port's models
(``models/blocks.Conv2d``) and the int8 oracle's 3x3 ``_qconv`` first
takes its own padding's worth of rows from its neighbours in H
(``halo_exchange``, point-to-point on the space group; zero rows at the
image's top and bottom, as the unsharded zero padding), then convolves
without padding in H. So ``spatial_shard_infer(model) ==`` the unsharded
forward everywhere, borders included. Pooling and k == s transposed convs
are local when the shard height divides their stride; any other
transposed conv raises under the context. Globally coupled ops (FFTs,
global pooling, whole-image attention) are not routed through it: a
model that has them gives other logits sharded, so ``cli infer
--spatial`` takes the U-Net alone (``cli.SPATIAL_MODELS``).
"""

from __future__ import annotations

import contextlib

import torch

from .collectives import all_gather_cat, exchange
from .mesh import SPACE_AXIS, Mesh
from .sharding import shard_params

# (axis name, mesh) pairs; while non-empty, convs exchange halos
_SPATIAL: list[tuple[str, Mesh]] = []


@contextlib.contextmanager
def spatial_partitioning(axis_name: str = SPACE_AXIS,
                         mesh: Mesh | None = None):
    """Within this context the port's convs exchange halos over
    ``axis_name`` of ``mesh``."""
    if mesh is None:
        raise ValueError("spatial_partitioning: a mesh is needed (the "
                         "ranks of its space axis exchange the rows)")
    _SPATIAL.append((axis_name, mesh))
    try:
        yield
    finally:
        _SPATIAL.pop()


def current_spatial_axis() -> str | None:
    return _SPATIAL[-1][0] if _SPATIAL else None


def halo_exchange(x: torch.Tensor, halo: int,
                  axis_name: str = SPACE_AXIS, edge: str = "zero", *,
                  dim: int = 1, mesh: Mesh | None = None) -> torch.Tensor:
    """Extend this rank's H-shard with ``halo`` rows of each neighbour.

    x: the local shard, H along ``dim`` (1 for NHWC, as JAX's; the port's
    NCHW convs pass 2). Returns it with ``2 * halo`` more rows along
    ``dim``. The outermost shards take ``edge`` rows: "zero" (the
    unsharded conv's zero padding) or "replicate" (the edge row
    repeated). ``mesh`` defaults to the ``spatial_partitioning``
    context's."""
    if edge not in ("zero", "replicate"):
        raise ValueError(f"edge={edge!r}: 'zero' or 'replicate'")
    if mesh is None:
        if not _SPATIAL:
            raise ValueError("halo_exchange: no mesh given and no "
                             "spatial_partitioning context")
        mesh = _SPATIAL[-1][1]
    h = x.shape[dim]
    if not 0 < halo <= h:
        raise ValueError(f"halo {halo} for a shard of {h} rows")
    n, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    ranks = mesh.axis_ranks(axis_name)
    top, bot = x.narrow(dim, 0, halo), x.narrow(dim, h - halo, halo)
    from_prev, from_next = (None, None)
    if n > 1:
        # my top rows go to the shard above, my bottom rows below
        from_prev, from_next = exchange(
            top, bot, ranks[idx - 1] if idx > 0 else None,
            ranks[idx + 1] if idx < n - 1 else None,
            mesh.group(axis_name))

    def edge_rows(rows, at):
        if edge == "zero":
            return torch.zeros_like(rows)
        reps = [1] * x.dim()
        reps[dim] = halo
        return x.narrow(dim, at, 1).repeat(reps)

    if from_prev is None:
        from_prev = edge_rows(top, 0)
    if from_next is None:
        from_next = edge_rows(bot, h - 1)
    out = torch.cat([from_prev, x, from_next], dim=dim)
    if x.dim() == 4 and x.is_contiguous(memory_format=torch.channels_last):
        # the layout the unsharded conv would have read (a conv picks its
        # kernels, and so its order of additions, by it)
        out = out.contiguous(memory_format=torch.channels_last)
    return out


def spatial_shard_infer(apply_fn, variables, images: torch.Tensor,
                        mesh: Mesh) -> torch.Tensor:
    """``apply_fn(variables, x)`` with H sharded over the "space" axis.

    Every rank passes the same NHWC ``images``; the variables (a module or
    a tree of tensors) are replicated from the mesh's first rank. Each
    rank runs its H-shard under ``spatial_partitioning`` and the NHWC
    outputs are gathered back in H order, the whole result on every rank.
    Exact: it equals the unsharded forward. The shard height must stay
    divisible by every stride of the network (H / n a multiple of 16 for
    the 4-pool U-Net)."""
    n = mesh.axis_size(SPACE_AXIS)
    H = images.shape[1]
    if H % n:
        raise ValueError(f"H={H} not divisible by the {n} space ranks")
    variables = shard_params(mesh, variables)
    hs = H // n
    # contiguous, as the whole batch is: a conv picks its kernels by the
    # layout it is given
    x = images.narrow(1, mesh.axis_index(SPACE_AXIS) * hs, hs).contiguous()
    with spatial_partitioning(SPACE_AXIS, mesh):
        out = apply_fn(variables, x)
    if n == 1:
        return out
    return all_gather_cat(out, mesh.group(SPACE_AXIS), dim=1)


def sliding_window_infer(apply_fn, variables, images: torch.Tensor,
                         tile: int = 512, overlap: int = 64,
                         batch_tiles: int = 8) -> torch.Tensor:
    """Single-device tiled inference over oversized B-scans (H only): NHWC
    tiles of ``tile`` rows every ``tile - overlap`` rows (the last one
    flush with the bottom), the logits averaged where tiles overlap.
    ``batch_tiles`` is JAX's argument and changes nothing here."""
    del batch_tiles
    B, H, W, _ = images.shape
    if H <= tile:
        return apply_fn(variables, images)
    stride = tile - overlap
    starts = list(range(0, max(H - tile, 0) + 1, stride))
    if starts[-1] + tile < H:
        starts.append(H - tile)
    out_acc = w_acc = None
    for s in starts:
        logits = apply_fn(variables, images[:, s: s + tile])
        if out_acc is None:
            out_acc = torch.zeros((B, H, W, logits.shape[-1]),
                                  dtype=logits.dtype, device=logits.device)
            w_acc = torch.zeros((1, H, 1, 1), dtype=logits.dtype,
                                device=logits.device)
        out_acc[:, s: s + tile] += logits
        w_acc[:, s: s + tile] += 1.0
    return out_acc / w_acc
