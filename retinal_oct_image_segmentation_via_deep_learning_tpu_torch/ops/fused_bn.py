"""Training BatchNorm: one-pass statistics on K6 and a hand-written backward.

The counterpart of the JAX package's ``ops/fused_bn.py``. ``bn_train(x,
gamma, beta) -> (y, mean, var)`` on channels-last input of any rank, with
its formulas kept exactly:

* statistics: one pass of K6 (``pair_sums``) for [sum x, sum x^2] in fp32,
  mean = sum / m, the one-pass biased variance max(sum x^2 / m - mean^2, 0);
* y = x * scale + shift in fp32 (scale = gamma * rsqrt(var + 1e-5)), cast
  to the dtype of x;
* backward: one K6 pass for [sum dy, sum dy * x], then dx from the ``c1`` /
  ``c0`` terms of ``_bn_bwd``, dx in the dtype of x.

mean and var carry no gradient; the caller applies the running-stat update
(flax semantics, ``models/blocks.BatchNorm`` and
``training/packed_unet.py``). The TPU's lane-dense relayout for C < 128 has
no counterpart here. The normalize and dx passes stay plain torch
elementwise ops, as they are XLA in JAX.

Under ``parallel.collectives.data_parallel`` the statistics are those of
the global batch, as JAX's step over a batch sharded on "data": K6's
[sum x, sum x^2] and, in the backward, [sum dy, sum dy * x] are summed
over the data group before use (m the global row count); the gamma and
beta gradients stay this rank's share, which the trainer sums over the
ranks with the other gradients.

``pair_sums`` runs K6 (``csrc/bn_pair_sums.cu``) for a CUDA tensor and its
plain version (float64 sums, rounded to float32) only for a CPU tensor.
K6 is one cooperative launch a call; ``pair_sums_plan`` cuts its rows and
channels, and fixes the order of its additions.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..parallel.collectives import all_reduce_sum, current_data_group
from . import _build
from .conv_int8 import _check, _stream

EPS = 1e-5


def pair_sums_reference(a: torch.Tensor,
                        b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of K6: (..., C) -> (2, C) float32, [sum a, sum a*a]
    or [sum a, sum a*b] over all but the last axis, summed in float64."""
    a64 = a.reshape(-1, a.shape[-1]).double()
    b64 = a64 if b is None else b.reshape(-1, b.shape[-1]).double()
    return torch.stack([a64.sum(0), (a64 * b64).sum(0)]).float()


THREADS = 256  # a K6 block's threads (csrc/bn_pair_sums.cu: THREADS)
VEC = 8  # channels a lane owns where C % 8 == 0: 16 bytes of a bf16 row
# block steps a block takes at least (each lane adds this many rows or
# more), so that its tree, partial and share of the barrier are small
# beside its loads
MIN_STEPS = 32


class PairSumsPlan(NamedTuple):
    """K6's launch for one call (``pair_sums_plan``). A lane owns ``vec``
    consecutive channels (a channel group; 16-byte loads where vec = 8) and
    the block's ``THREADS`` threads are ``rows_step`` rows x ``lanes``
    lanes, thread t = ry * lanes + lane (threads past rows_step * lanes
    idle). Block g of the ``grid`` takes rows [g * rows_block, min(M, (g +
    1) * rows_block)); its thread (ry, lane) adds, for channel groups lane,
    lane + lanes, ..., the rows ry, ry + rows_step, ... of that range in
    order into one Kahan pair (s, e) a channel and product; the block's
    rows_step pairs of a channel are then joined by a fixed tree (n items:
    item i += item i + ceil(n/2) for i < floor(n/2), until one is left),
    and the block writes its partial for slot g. After a grid-wide barrier
    output i (of 2C: [sum a | sum a*b]) is taken by a warp of block i mod
    grid: lane l joins the partials g = l, l + 32, ... in order, then the
    warp's shuffle-down tree (16, 8, 4, 2, 1) joins the lanes. So the
    order of every addition is a function of the plan alone."""

    M: int
    C: int
    vec: int
    lanes: int
    rows_step: int
    grid: int
    rows_block: int

    def rows(self, g: int) -> range:
        """Block ``g``'s rows."""
        return range(g * self.rows_block,
                     min(self.M, (g + 1) * self.rows_block))

    def text(self) -> str:
        return (f"vec {self.vec} lanes {self.lanes} rows/step "
                f"{self.rows_step} grid {self.grid} rows/block "
                f"{self.rows_block}")


@functools.lru_cache(maxsize=256)
def pair_sums_plan(M: int, C: int, dtype: torch.dtype, *, co_resident: int,
                   aligned: bool = True) -> PairSumsPlan:
    """K6's plan over (M, C) rows of ``dtype`` (float32 or bfloat16).
    ``co_resident``: the blocks the card holds at once (the launch is
    cooperative: every block must be resident); ``aligned``: the inputs are
    16-byte aligned.

    A lane owns 8 channels where C % 8 == 0 (and aligned), else one. A
    block covers up to THREADS channel groups at once, in as many rows as
    its threads allow. The grid is the lesser of the blocks that hold work
    (each at least MIN_STEPS block steps) and ``co_resident``; the rows are
    then dealt in whole block steps. ``dtype`` is checked, not used: a
    lane's 8 channels are one 16-byte load of bf16 and two of fp32."""
    _check(dtype in (torch.float32, torch.bfloat16),
           f"pair_sums_plan: dtype {dtype}, expected float32 or bfloat16")
    vec = VEC if C % VEC == 0 and aligned else 1
    lanes = min(C // vec, THREADS)
    rows_step = THREADS // lanes
    steps = max(1, -(-M // rows_step))
    grid = max(1, min(-(-steps // MIN_STEPS), co_resident))
    rows_block = -(-steps // grid) * rows_step
    grid = max(1, -(-M // rows_block))
    return PairSumsPlan(M, C, vec, lanes, rows_step, grid, rows_block)


@functools.lru_cache(maxsize=64)
def _co_resident(index: int, bf16: bool, two: bool, vec: int) -> int:
    """Blocks of this K6 instance the card holds at once (the occupancy
    API's blocks an SM times the SMs)."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.lib().octseg_bn_pair_sums_resident(
            int(bf16), int(two), vec, ctypes.addressof(n))
    _build.check(err, "pair_sums occupancy")
    return n.value


def launch_plan(a: torch.Tensor, b: torch.Tensor | None = None
                ) -> PairSumsPlan:
    """The plan ``pair_sums`` launches for contiguous CUDA tensors ``a``
    (and ``b``) of one dtype."""
    C = a.shape[-1]
    M = a.numel() // C
    aligned = a.data_ptr() % 16 == 0 and (b is None
                                          or b.data_ptr() % 16 == 0)
    vec = VEC if C % VEC == 0 and aligned else 1
    bf16 = a.dtype == torch.bfloat16
    index = a.device.index if a.device.index is not None \
        else torch.cuda.current_device()
    return pair_sums_plan(M, C, a.dtype, aligned=aligned,
                          co_resident=_co_resident(index, bf16,
                                                   b is not None, vec))


def pair_sums(a: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """K6: per-channel [sum a, sum a*a] (b None) or [sum a, sum a*b] in
    fp32, (2, C), over a channels-last float32 or bfloat16 tensor."""
    if a.device.type == "cpu":
        return pair_sums_reference(a, b)
    dev = a.device
    _check(dev.type == "cuda", f"pair_sums: unsupported device {dev}")
    C = a.shape[-1]
    if b is not None:
        _check(b.shape == a.shape and b.device == dev,
               f"pair_sums: b {tuple(b.shape)} on {b.device} for a "
               f"{tuple(a.shape)} on {dev}")
        if b.dtype != a.dtype:  # both exact in float32
            a, b = a.float(), b.float()
        b = b.contiguous()
    _check(a.dtype in (torch.float32, torch.bfloat16),
           f"pair_sums: dtype {a.dtype}, expected float32 or bfloat16")
    a = a.contiguous()
    with torch.cuda.device(dev):
        plan = launch_plan(a, b)
        part = torch.empty((2, 2 * C, plan.grid), dtype=torch.float32,
                           device=dev)
        out = torch.empty((2, C), dtype=torch.float32, device=dev)
        err = _build.lib().octseg_bn_pair_sums(
            a.data_ptr(), None if b is None else b.data_ptr(),
            part.data_ptr(), out.data_ptr(), plan.M, C, plan.vec,
            plan.lanes, plan.rows_step, plan.grid, plan.rows_block,
            int(a.dtype == torch.bfloat16), _stream(a))
    _build.check(err, "pair_sums")
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


def _global(sums: torch.Tensor, m: int, group):
    """K6's sums and the row count over the data group (as they are
    without one)."""
    if group is None:
        return sums, m
    return all_reduce_sum(sums, group), m * torch.distributed.get_world_size(
        group)


def _stats(x: torch.Tensor, m: int, group=None):
    sums, m = _global(pair_sums(x), m, group)
    mean = sums[0] / m
    var = torch.clamp_min(sums[1] / m - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + EPS)


class _BNTrain(torch.autograd.Function):
    """``bn_train`` with the JAX package's ``_bn_fwd`` / ``_bn_bwd``. K6 is
    looked up by name at call time."""

    @staticmethod
    def forward(ctx, x, gamma, beta):
        m = x.numel() // x.shape[-1]
        ctx.group = current_data_group()
        mean, var, inv = _stats(x, m, ctx.group)
        scale = gamma.float() * inv
        shift = beta.float() - mean * scale
        y = (x.float() * scale + shift).to(x.dtype)
        ctx.save_for_backward(x, mean, inv, gamma)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, gamma = ctx.saved_tensors
        m = x.numel() // x.shape[-1]
        local = pair_sums(dy, x)
        sums, m = _global(local, m, ctx.group)
        dbeta = sums[0]
        dgamma = (sums[1] - mean * dbeta) * inv
        g = gamma.float() * inv
        c1 = g * dgamma * inv / m
        c0 = g * (dbeta + dgamma * inv * (-mean)) / m
        dx = (dy.float() * g - x.float() * c1 - c0).to(x.dtype)
        if ctx.group is not None:  # this rank's share of the gradients
            dbeta = local[0]
            dgamma = (local[1] - mean * dbeta) * inv
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Train-mode BN over the last axis: (y in x.dtype, batch mean, biased
    batch var), flax semantics. mean and var carry no gradient."""
    return _BNTrain.apply(x, gamma, beta)
