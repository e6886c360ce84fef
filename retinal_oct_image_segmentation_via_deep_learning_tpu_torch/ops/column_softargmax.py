"""K12: the column softmax, soft-argmax position and positional std of the
SDNet ``LayerEngine`` (the JAX package's ``ops/pallas_kernels.py``).

``column_softargmax(x)`` takes boundary logits x (B, L, H, W) and returns,
in float32,

* ``sm``  (B, L, H, W): the softmax of each column over H,
* ``pos`` (B, L, W): its soft-argmax, sum_h sm[h] * h,
* ``std`` (B, L, W): sqrt(sum_h sm[h] * (h - pos)^2).

The layout is NCHW: W is the contiguous axis, so the kernel's warps read
whole rows of 32 neighbouring columns. The JAX function's (B, H, W, L)
layout and its 128-lane padding of W are TPU layout; the tests convert.

``column_softargmax_forward`` runs K12 (``csrc/column_softargmax.cu``) for a
CUDA tensor and its plain version (``column_softargmax_reference``) only for
a CPU tensor. ``column_softargmax_plan`` names the body a shape takes: for
H <= 512 a thread holds its rows in registers and x is read once; beyond,
the three-pass body reads x three times.

``column_softargmax`` is differentiable: the TPU kernel has no backward
kernel (JAX differentiates its XLA path), so the backward here is the
analytic VJP in torch ops. With G_h = g_sm[h] + g_pos * h
+ g_var * (h - pos)^2 and g_var = g_std / (2 * std),

    dx[h] = sm[h] * (G_h - sum_k sm[k] * G_k).

A cotangent that autograd does not supply (an output no loss uses, as the
SDNet trainer never uses ``std``) is absent, not zero: a one-hot column has
std = 0, and a zero g_std would give 0 / 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import _build
from .conv_int8 import _check, _stream


def column_softargmax_reference(x: torch.Tensor):
    """Plain version of K12 (any device): the JAX reference's formulas
    (softmax over H, then the position, then the centred std) in float64,
    each output rounded once to float32. A float32 sum over 512 rows is off
    by up to ~2e-6 of itself, as far as a peaked column's softmax may move
    against the kernel's compensated sums."""
    xd = x.double()
    sm = torch.softmax(xd, dim=2)
    rows = torch.arange(x.shape[2], dtype=torch.float64,
                        device=x.device).view(1, 1, -1, 1)
    pos = torch.sum(sm * rows, dim=2)
    std = torch.sqrt(torch.sum(sm * (rows - pos.unsqueeze(2)) ** 2, dim=2))
    return sm.float(), pos.float(), std.float()


COLS = 32  # csrc/column_softargmax.cu: columns a block (threadIdx.x)
ROW_WARPS = 16  # row lanes a block (threadIdx.y), one warp each
REG_ROWS = (8, 16, 32)  # the register body's instances: rows a thread


class ColumnSoftargmaxPlan(NamedTuple):
    """K12's launch for (B, L, H, W): ``body`` "regs" (a thread holds its
    ``rows`` rows h = ty, ty + 16, ... in registers; ``full``: H = 16 *
    rows and W % 32 == 0, so nothing is predicated and 2 blocks share an
    SM) or "three_pass" (``rows`` 0), on a ``grid`` (x, y) of blocks
    ``block`` (32 columns, 16 row warps); the last strip of a plane holds
    ``W % 32`` columns, if any."""

    body: str
    rows: int
    full: bool
    grid: tuple[int, int]
    block: tuple[int, int]

    def text(self) -> str:
        rows = (f" R={self.rows}{' full' if self.full else ''}"
                if self.body == "regs" else "")
        return (f"{self.body}{rows} grid {self.grid[0]}x{self.grid[1]} "
                f"block {self.block[0]}x{self.block[1]}")


def column_softargmax_plan(B: int, L: int, H: int,
                           W: int) -> ColumnSoftargmaxPlan:
    """The body ``octseg_column_softargmax`` launches for x (B, L, H, W):
    the register body with the fewest rows of ``REG_ROWS`` that covers
    ceil(H / 16); the three-pass body where none does (H > 512) or a plane
    holds 2^31 elements or more (the register body's offsets are
    32-bit)."""
    need = -(-H // ROW_WARPS)
    rows = next((r for r in REG_ROWS if r >= need), 0)
    if H * W >= 2 ** 31:
        rows = 0
    full = bool(rows) and H == ROW_WARPS * rows and W % COLS == 0
    return ColumnSoftargmaxPlan("regs" if rows else "three_pass", rows, full,
                                (-(-W // COLS), B * L), (COLS, ROW_WARPS))


def column_softargmax_forward(x: torch.Tensor):
    """K12: (B, L, H, W) -> (sm, pos, std) float32, without autograd."""
    _check(x.dim() == 4, f"column_softargmax: expected (B, L, H, W), got "
           f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return column_softargmax_reference(x)
    dev = x.device
    _check(dev.type == "cuda", f"column_softargmax: unsupported device {dev}")
    _check(x.dtype == torch.float32,
           f"column_softargmax: dtype {x.dtype}, expected float32")
    B, L, H, W = x.shape
    _check(B * L <= 65535 and H >= 1 and W >= 1,
           f"column_softargmax: shape {tuple(x.shape)} (B * L at most 65535)")
    x = x.contiguous()
    sm = torch.empty_like(x)
    pos = torch.empty((B, L, W), dtype=torch.float32, device=dev)
    std = torch.empty_like(pos)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_column_softargmax(
            x.data_ptr(), sm.data_ptr(), pos.data_ptr(), std.data_ptr(),
            B * L, H, W, _stream(x))
    _build.check(err, "column_softargmax")
    column_softargmax_forward.launches += 1
    return sm, pos, std


column_softargmax_forward.launches = 0


class _ColumnSoftargmax(torch.autograd.Function):
    """K12 forward (looked up by name at call time), analytic backward."""

    @staticmethod
    def forward(ctx, x):
        ctx.set_materialize_grads(False)
        sm, pos, std = column_softargmax_forward(x)
        ctx.save_for_backward(sm, pos, std)
        return sm, pos, std

    @staticmethod
    def backward(ctx, g_sm, g_pos, g_std):
        sm, pos, std = ctx.saved_tensors
        rows = torch.arange(sm.shape[2], dtype=sm.dtype,
                            device=sm.device).view(1, 1, -1, 1)
        G = g_sm
        if g_pos is not None:
            G = g_pos.unsqueeze(2) * rows if G is None \
                else G + g_pos.unsqueeze(2) * rows
        if g_std is not None:
            g_var = (g_std / (2.0 * std)).unsqueeze(2)
            t = g_var * (rows - pos.unsqueeze(2)) ** 2
            G = t if G is None else G + t
        if G is None:
            return None
        return sm * (G - torch.sum(sm * G, dim=2, keepdim=True))


def column_softargmax(x: torch.Tensor):
    """(sm, pos, std) of boundary logits x (B, L, H, W); differentiable."""
    return _ColumnSoftargmax.apply(x)
