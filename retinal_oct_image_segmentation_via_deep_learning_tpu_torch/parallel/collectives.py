"""The collectives the parallel runtime is built on, over
``torch.distributed`` process groups.

Two ranks on one card must use gloo (NCCL refuses two ranks on one
device). Installed gloo (PyTorch 2.x on the H100 machine, ``chip_smoke.py``
phase 35's probe) takes CUDA tensors in ``all_reduce``, ``broadcast`` and
``all_gather``, but not in ``send``/``recv``: so on a gloo group the rows
that ``exchange`` sends go through host buffers (copied to the host and
back; the convs stay on the card), and the collectives take the CUDA
tensors as they are. NCCL groups take CUDA tensors everywhere.

``global_sum`` is the differentiable sum over a group that the
data-parallel losses use; ``data_parallel`` names the group that train-mode
BatchNorm (``ops/fused_bn``) and the losses (``training/losses``,
``ops/dice_ce``) reduce over while it is active. ``data_group`` is a mesh's
data group and ``sum_gradients`` the gradient sum over it that both train
steps (``training/trainer``, ``training/packed_unet``) take after their
backward.

With tracing on (``utils/profiling``) each collective adds one to
``collective.calls`` and the bytes this rank puts in to
``collective.bytes``.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..utils.profiling import count
from .mesh import DATA_AXIS, Mesh


def _out(t: torch.Tensor, group=None, p2p: bool = False) -> torch.Tensor:
    """A contiguous copy the backend takes: on the host for gloo's
    point-to-point ops."""
    staged = p2p and t.device.type != "cpu" and \
        dist.get_backend(group) == "gloo"
    return t.detach().to("cpu" if staged else t.device,
                         copy=True).contiguous()


def _counted(nbytes: int) -> None:
    count("collective.calls")
    count("collective.bytes", nbytes)


def group_size(group) -> int:
    return dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``group`` (a new tensor on
    ``t``'s device)."""
    buf = _out(t, group)
    _counted(buf.nbytes)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` (one shape) concatenated along ``dim`` in the
    order of their ranks in ``group``."""
    buf = _out(t, group)
    _counted(buf.nbytes)
    parts = [torch.empty_like(buf) for _ in range(group_size(group))]
    dist.all_gather(parts, buf, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, src: int, group) -> torch.Tensor:
    """``t`` of global rank ``src`` on every rank of ``group``, copied into
    ``t`` in place (and returned)."""
    buf = _out(t, group)
    _counted(buf.nbytes)
    dist.broadcast(buf, src=src, group=group)
    with torch.no_grad():
        t.copy_(buf)
    return t


def exchange(to_prev: torch.Tensor | None, to_next: torch.Tensor | None,
             prev: int | None, nxt: int | None, group):
    """Point-to-point swap with the neighbours of a chain of ranks:
    ``to_prev`` goes to global rank ``prev`` and ``to_next`` to ``nxt``
    (None where there is no neighbour). -> (from_prev, from_next), each
    shaped as the tensor sent the other way, on its device."""
    ops, recv, sent = [], {}, 0
    for peer, send, key in ((prev, to_prev, "prev"), (nxt, to_next, "next")):
        if peer is None:
            continue
        buf = _out(send, group, p2p=True)
        recv[key] = torch.empty_like(buf)
        sent += buf.nbytes
        ops.append(dist.P2POp(dist.isend, buf, peer, group))
        ops.append(dist.P2POp(dist.irecv, recv[key], peer, group))
    _counted(sent)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    dev = (to_prev if to_prev is not None else to_next).device
    return tuple(recv[k].to(dev) if k in recv else None
                 for k in ("prev", "next"))


class _GlobalSum(torch.autograd.Function):
    """The sum over a group in the forward; the cotangent unchanged in the
    backward. Every rank computes the same global loss from the summed
    values and back-propagates it through its own shard; summing the
    parameter gradients over the ranks afterwards gives the gradient of
    the global loss, so the sum's backward passes no collective."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce_sum(t, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


_DATA_GROUPS: list = []


@contextlib.contextmanager
def data_parallel(group):
    """While active, train-mode BatchNorm and the segmentation losses
    reduce their sums over ``group`` (None: over this rank alone)."""
    _DATA_GROUPS.append(group)
    try:
        yield
    finally:
        _DATA_GROUPS.pop()


def current_data_group():
    return _DATA_GROUPS[-1] if _DATA_GROUPS else None


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the active data-parallel group (``t`` itself
    outside ``data_parallel``); differentiable (``_GlobalSum``)."""
    group = current_data_group()
    return t if group is None else _GlobalSum.apply(t, group)


def data_size() -> int:
    """Ranks of the active data-parallel group (1 outside it)."""
    group = current_data_group()
    return 1 if group is None else group_size(group)


def data_group(mesh: Mesh | None):
    """The mesh's data group where its data axis has more than one rank
    (else None: the step runs on this rank alone)."""
    if mesh is None or mesh.axis_size(DATA_AXIS) == 1:
        return None
    return mesh.group(DATA_AXIS)


def sum_gradients(model: torch.nn.Module, group) -> None:
    """Sum the parameter gradients over ``group``, in one flat buffer."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]), group)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))
