"""Training BatchNorm: one-pass statistics on K6 and a hand-written backward.

The counterpart of the JAX package's ``ops/fused_bn.py``. ``bn_train(x,
gamma, beta, relu=False) -> (y, mean, var)`` on channels-last input of any
rank, with its formulas kept exactly:

* statistics: one pass of K6 (``pair_sums``) for [sum x, sum x^2] in fp32,
  mean = sum / m, the one-pass biased variance max(sum x^2 / m - mean^2, 0);
* y = x * scale + shift in fp32 (scale = gamma * rsqrt(var + 1e-5)), cast
  to the dtype of x, then the ReLU where ``relu`` (the packed U-Net's
  conv-BN-ReLU fixes it);
* backward: dy zeroed where the ReLU was closed (y <= 0, as
  ``threshold_backward``), one K6 pass for [sum dy, sum dy * x], then dx
  from the ``c1`` / ``c0`` terms of ``_bn_bwd``, dx in the dtype of x.

mean and var carry no gradient; the caller applies the running-stat update
(flax semantics, ``models/blocks.BatchNorm`` and
``training/packed_unet.py``). The TPU's lane-dense relayout for C < 128 has
no counterpart here.

The per-element passes, which XLA fuses in JAX, are two kernels on the
card: K13 (``bn_apply``: normalize and ReLU) and K14 (``bn_dx``), with
K6's masked mode for the backward's sums (``csrc/bn_apply.cu``,
``csrc/bn_pair_sums.cu``). K13 and K14 equal their plain versions
(``bn_apply_reference``, ``bn_dx_reference``: the eager ops the step ran
before) bit for bit, and the masked K6 equals K6 over the ReLU's zeroed
dy on the same plan (``pair_sums_reference`` takes the mask too). Every
CUDA tensor takes the kernels, made contiguous (channels last) first, as
K6 makes its input (the channels-first views of
``models/blocks.BatchNorm`` are copied once a pass), and in float32 or
bfloat16 (any other dtype raises); the plain versions run only for a CPU
tensor.

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
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def bn_apply_reference(x: torch.Tensor, scale: torch.Tensor,
                       shift: torch.Tensor, relu: bool = False
                       ) -> torch.Tensor:
    """Plain version of K13: round(x * scale + shift) to x's dtype (the
    product and the sum each rounded in float32), then the ReLU."""
    y = (x.float() * scale + shift).to(x.dtype)
    return torch.relu(y) if relu else y


def relu_closed(x: torch.Tensor, scale: torch.Tensor,
                shift: torch.Tensor) -> torch.Tensor:
    """Where the ReLU after the forward's normalize was closed (y <= 0):
    there its backward (``threshold_backward``) zeroes the gradient."""
    return bn_apply_reference(x, scale, shift) <= 0


def bn_dx_reference(dy: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                    c1: torch.Tensor, c0: torch.Tensor, mask=None
                    ) -> torch.Tensor:
    """Plain version of K14: (dy * g - x * c1 - c0) in float32, rounded to
    x's dtype; ``mask`` = the forward's (scale, shift) zeroes dy first
    where the ReLU was closed."""
    if mask is not None:
        dy = dy.masked_fill(relu_closed(x, *mask), 0)
    return (dy.float() * g - x.float() * c1 - c0).to(x.dtype)


def pair_sums_reference(a: torch.Tensor, b: torch.Tensor | None = None,
                        mask=None) -> torch.Tensor:
    """Plain version of K6: (..., C) -> (2, C) float32, [sum a, sum a*a]
    or [sum a, sum a*b] over all but the last axis, summed in float64;
    ``mask`` = (scale, shift) first zeroes a = dy where the ReLU on b = x
    was closed (K6's masked mode)."""
    if mask is not None:
        a = a.masked_fill(relu_closed(b, *mask), 0)
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


def _resident(entry: str, index: int, *args: int) -> int:
    """Blocks of a kernel instance the card holds at once (the occupancy
    API's blocks an SM times the SMs): ``entry`` is its C entry point."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = getattr(_build.lib(), entry)(*args, ctypes.addressof(n))
    _build.check(err, f"{entry} occupancy")
    return n.value


@functools.lru_cache(maxsize=64)
def _co_resident(index: int, bf16: bool, two: bool, vec: int,
                 masked: bool = False) -> int:
    """Blocks of this K6 instance the card holds at once. The masked mode
    takes the plan of the unmasked backward (the same order of additions)
    unless the card holds fewer of its blocks."""
    n = _resident("octseg_bn_pair_sums_resident", index, int(bf16),
                  int(two), vec)
    if masked:
        n = min(n, _resident("octseg_bn_pair_sums_masked_resident", index,
                             int(bf16), vec))
    return n


def _index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None \
        else torch.cuda.current_device()


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def launch_plan(a: torch.Tensor, b: torch.Tensor | None = None,
                masked: bool = False) -> PairSumsPlan:
    """The plan ``pair_sums`` launches for contiguous CUDA tensors ``a``
    (and ``b``) of one dtype (``masked``: in its masked mode)."""
    C = a.shape[-1]
    M = a.numel() // C
    aligned = _aligned(a) if b is None else _aligned(a, b)
    vec = VEC if C % VEC == 0 and aligned else 1
    bf16 = a.dtype == torch.bfloat16
    return pair_sums_plan(M, C, a.dtype, aligned=aligned,
                          co_resident=_co_resident(_index(a), bf16,
                                                   b is not None, vec,
                                                   masked))


def pair_sums(a: torch.Tensor, b: torch.Tensor | None = None,
              mask=None) -> torch.Tensor:
    """K6: per-channel [sum a, sum a*a] (b None) or [sum a, sum a*b] in
    fp32, (2, C), over a channels-last float32 or bfloat16 tensor.
    ``mask`` = the forward's (scale, shift) (with b = x): a = dy is taken
    as 0 where the ReLU on round(x * scale + shift) was closed, in the
    kernel's registers (its masked mode)."""
    if a.device.type == "cpu":
        return pair_sums_reference(a, b, mask)
    dev = a.device
    _check(dev.type == "cuda", f"pair_sums: unsupported device {dev}")
    C = a.shape[-1]
    if b is not None:
        _check(b.shape == a.shape and b.device == dev,
               f"pair_sums: b {tuple(b.shape)} on {b.device} for a "
               f"{tuple(a.shape)} on {dev}")
        if b.dtype != a.dtype:  # both exact in float32
            _check(mask is None, "pair_sums: a masked call takes a and b "
                   "of one dtype (the mask rounds to it)")
            a, b = a.float(), b.float()
        b = b.contiguous()
    _check(mask is None or b is not None,
           "pair_sums: the mask applies to the backward's (dy, x)")
    _check(a.dtype in KERNEL_DTYPES,
           f"pair_sums: dtype {a.dtype}, expected float32 or bfloat16")
    a = a.contiguous()
    with torch.cuda.device(dev):
        plan = launch_plan(a, b, mask is not None)
        part = torch.empty((2, 2 * C, plan.grid), dtype=torch.float32,
                           device=dev)
        out = torch.empty((2, C), dtype=torch.float32, device=dev)
        args = (plan.M, C, plan.vec, plan.lanes, plan.rows_step, plan.grid,
                plan.rows_block, int(a.dtype == torch.bfloat16), _stream(a))
        if mask is None:
            err = _build.lib().octseg_bn_pair_sums(
                a.data_ptr(), None if b is None else b.data_ptr(),
                part.data_ptr(), out.data_ptr(), *args)
        else:
            scale, shift = (_terms(t, C, dev) for t in mask)
            err = _build.lib().octseg_bn_pair_sums_masked(
                a.data_ptr(), b.data_ptr(), scale.data_ptr(),
                shift.data_ptr(), part.data_ptr(), out.data_ptr(), *args)
    _build.check(err, "pair_sums")
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


def _terms(t: torch.Tensor, C: int, dev: torch.device) -> torch.Tensor:
    """A per-channel term as the kernels read it: contiguous float32 (C,)
    on ``dev``."""
    _check(t.shape == (C,) and t.device == dev and t.dtype == torch.float32,
           f"per-channel term {tuple(t.shape)} {t.dtype} on {t.device}, "
           f"expected float32 ({C},) on {dev}")
    return t.contiguous()


APPLY_UNROLL = 4  # rows a K13/K14 lane has in flight (csrc/bn_apply.cu)


class ApplyPlan(NamedTuple):
    """K13's and K14's launch for one call (``apply_plan``): a lane owns
    ``vec`` consecutive channels and keeps their terms in registers; the
    block's ``THREADS`` threads are ``rows_step`` rows x ``lanes`` lanes
    (thread t = ry * lanes + lane), lane l taking the channel groups l, l +
    lanes, ...; block g takes the rows g * rows_step + ry, then every
    ``grid * rows_step`` rows after."""

    M: int
    C: int
    vec: int
    lanes: int
    rows_step: int
    grid: int

    def text(self) -> str:
        return (f"vec {self.vec} lanes {self.lanes} rows/step "
                f"{self.rows_step} grid {self.grid}")


@functools.lru_cache(maxsize=256)
def apply_plan(M: int, C: int, *, co_resident: int,
               aligned: bool = True) -> ApplyPlan:
    """K13's and K14's plan over (M, C) rows: 8 channels a lane where C %
    8 == 0 (and every pointer 16-byte aligned), else one; as many rows a
    block step as its threads allow; blocks enough for ``APPLY_UNROLL``
    block steps each, at most ``co_resident`` (the card's blocks at once:
    the grid strides over the rest)."""
    vec = VEC if C % VEC == 0 and aligned else 1
    lanes = min(C // vec, THREADS)
    rows_step = THREADS // lanes
    grid = max(1, min(-(-M // (rows_step * APPLY_UNROLL)), co_resident))
    return ApplyPlan(M, C, vec, lanes, rows_step, grid)


@functools.lru_cache(maxsize=64)
def _apply_co_resident(index: int, backward: bool, bf16: bool, vec: int,
                       relu: bool) -> int:
    return _resident("octseg_bn_apply_resident", index, int(backward),
                     int(bf16), vec, int(relu))


def _apply_launch(x: torch.Tensor, *others: torch.Tensor, backward: bool,
                  relu: bool) -> ApplyPlan:
    """The plan K13 (K14 where ``backward``) launches over x and the
    other tensors of the call."""
    C = x.shape[-1]
    aligned = _aligned(x, *others)
    vec = VEC if C % VEC == 0 and aligned else 1
    return apply_plan(x.numel() // C, C, aligned=aligned,
                      co_resident=_apply_co_resident(
                          _index(x), backward, x.dtype == torch.bfloat16,
                          vec, relu))


def _kernel_input(t: torch.Tensor, what: str, like=None) -> torch.Tensor:
    """``t`` checked (a float32 or bfloat16 CUDA tensor, of ``like``'s
    shape, dtype and device where given) and made contiguous."""
    _check(t.device.type == "cuda" and t.dtype in KERNEL_DTYPES,
           f"{what}: expected a float32 or bfloat16 CUDA tensor, got "
           f"{t.dtype} on {t.device}")
    if like is not None:
        _check(t.shape == like.shape and t.dtype == like.dtype
               and t.device == like.device,
               f"{what}: {tuple(t.shape)} {t.dtype} on {t.device}, expected "
               f"{tuple(like.shape)} {like.dtype} on {like.device}")
    return t.contiguous()


def bn_apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
             relu: bool = False) -> torch.Tensor:
    """K13: ``bn_apply_reference`` in one pass, y in x's dtype (contiguous),
    over a channels-last float32 or bfloat16 CUDA tensor."""
    if x.device.type == "cpu":
        return bn_apply_reference(x, scale, shift, relu)
    x = _kernel_input(x, "bn_apply: x")
    C, dev = x.shape[-1], x.device
    scale, shift = _terms(scale, C, dev), _terms(shift, C, dev)
    y = torch.empty_like(x)
    with torch.cuda.device(dev):
        plan = _apply_launch(x, y, backward=False, relu=relu)
        err = _build.lib().octseg_bn_apply(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            plan.M, C, plan.vec, plan.lanes, plan.rows_step, plan.grid,
            int(relu), int(x.dtype == torch.bfloat16), _stream(x))
    _build.check(err, "bn_apply")
    bn_apply.launches += 1
    return y


bn_apply.launches = 0


def bn_dx(dy: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
          c1: torch.Tensor, c0: torch.Tensor, mask=None) -> torch.Tensor:
    """K14: ``bn_dx_reference`` in one pass, dx in x's dtype (contiguous),
    over channels-last CUDA tensors dy and x of one dtype (float32 or
    bfloat16); ``mask`` = the forward's (scale, shift)."""
    if x.device.type == "cpu":
        return bn_dx_reference(dy, x, g, c1, c0, mask)
    x = _kernel_input(x, "bn_dx: x")
    dy = _kernel_input(dy, "bn_dx: dy", like=x)
    C, dev = x.shape[-1], x.device
    g, c1, c0 = (_terms(t, C, dev) for t in (g, c1, c0))
    scale, shift = (None, None) if mask is None else \
        (_terms(t, C, dev) for t in mask)
    dx = torch.empty_like(x)
    with torch.cuda.device(dev):
        plan = _apply_launch(x, dy, dx, backward=True,
                             relu=mask is not None)
        err = _build.lib().octseg_bn_dx(
            dy.data_ptr(), x.data_ptr(), g.data_ptr(), c1.data_ptr(),
            c0.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), dx.data_ptr(),
            plan.M, C, plan.vec, plan.lanes, plan.rows_step, plan.grid,
            int(mask is not None), int(x.dtype == torch.bfloat16),
            _stream(x))
    _build.check(err, "bn_dx")
    bn_dx.launches += 1
    return dx


bn_dx.launches = 0


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
    """``bn_train`` with the JAX package's ``_bn_fwd`` / ``_bn_bwd``, and
    the ReLU after it where ``relu``. K6 (``pair_sums``), K13
    (``bn_apply``), K14 (``bn_dx``) and ``_global`` are looked up by name
    at call time. Saved for the backward: x and C-element terms (the mask
    is found again from x)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, relu):
        m = x.numel() // x.shape[-1]
        ctx.group = current_data_group()
        ctx.relu = relu
        # one copy of a view for K6 and K13 (x itself is saved)
        xk = x.contiguous() if x.device.type == "cuda" else x
        mean, var, inv = _stats(xk, m, ctx.group)
        scale = gamma.float() * inv
        shift = beta.float() - mean * scale
        y = bn_apply(xk, scale, shift, relu)
        ctx.save_for_backward(x, mean, inv, gamma, scale, shift)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mean, inv, gamma, scale, shift = ctx.saved_tensors
        m = x.numel() // x.shape[-1]
        if x.device.type == "cuda":  # as in the forward, for K6 and K14
            x, dy = x.contiguous(), dy.contiguous()
        mask = (scale, shift) if ctx.relu else None
        local = pair_sums(dy, x, mask=mask)
        sums, m = _global(local, m, ctx.group)
        dbeta = sums[0]
        dgamma = (sums[1] - mean * dbeta) * inv
        g = gamma.float() * inv
        c1 = g * dgamma * inv / m
        c0 = g * (dbeta + dgamma * inv * (-mean)) / m
        dx = bn_dx(dy, x, g, c1, c0, mask)
        if ctx.group is not None:  # this rank's share of the gradients
            dbeta = local[0]
            dgamma = (local[1] - mean * dbeta) * inv
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             relu: bool = False):
    """Train-mode BN over the last axis: (y in x.dtype, batch mean, biased
    batch var), flax semantics; ``relu`` applies the ReLU to y (and its
    mask to the backward). mean and var carry no gradient."""
    return _BNTrain.apply(x, gamma, beta, relu)
