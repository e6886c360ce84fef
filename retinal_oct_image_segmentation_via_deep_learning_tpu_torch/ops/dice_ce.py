"""K8 and K9: the fused Dice + cross-entropy loss (the JAX package's
``ops/pallas_loss.py``).

``dice_ce_loss_fused`` computes the same scalar as
``training/losses.dice_ce_loss`` in two passes over the logits:

* forward: K8 (``dice_ce_stats``) reduces the logits and labels to the
  (3C + 2,) fp32 statistics [sum p*t per class, sum p per class, count per
  class, sum ll*w, sum w]; the C-sized fold to the loss is plain torch;
* backward: the per-class coefficients A, B, wce are plain torch (C-sized),
  then K9 (``dice_ce_bwd``) recomputes the softmax and writes dlogits in the
  logits' dtype:

      dlogit_c = wce_l (p_c - t_c) + A_c t_c p_c + B_c p_c
                 - p_c (A_l p_l + sum_c' B_c' p_c')

No log-probabilities, probabilities or one-hot tensor reach device memory,
and nothing is recomputed but the softmax.

The kernels read NHWC logits (a thread owns a pixel, its C values are
contiguous), which is what the packed train step's head emits; ``nchw=True``
is permuted here. They take any H and W and at most 32 classes: a CUDA
tensor with more raises ``ValueError`` (there is no fallback). K8 and K9
move whole tiles of pixels by 16-byte copies (their launches are
``stats_plan``'s, one cooperative launch, and ``bwd_plan``'s), so their
logits and labels must be 16-byte aligned. Each wrapper runs its CUDA
kernel (``csrc/dice_ce.cu``) for a CUDA tensor and its plain version
(``*_reference``, float64 sums) only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .conv_int8 import _check, _check_vec, _stream

MAX_CLASSES = 32
_EPS = 1e-7
_THREADS = 256
BWD_TILE = _THREADS  # csrc/dice_ce.cu BWD_TP: K9's pixels a tile
BWD_STAGES = 2  # csrc/dice_ce.cu: the slots of K9's ring
STATS_TILE = 2 * _THREADS  # csrc/dice_ce.cu STATS_TP: K8's pixels a tile
STATS_STAGES = 2  # csrc/dice_ce.cu: the slots of K8's ring


def _softmax_onehot(x: torch.Tensor, labels: torch.Tensor):
    """(P, C) float64 log-softmax and probabilities, and the (P, C) float64
    one-hot of the labels (all-zero rows outside [0, C))."""
    C = x.shape[-1]
    logp = torch.log_softmax(x.reshape(-1, C).double(), dim=-1)
    classes = torch.arange(C, device=labels.device)
    t = (labels.reshape(-1, 1) == classes).double()
    return logp, logp.exp(), t


def dice_ce_stats_reference(x: torch.Tensor, labels: torch.Tensor,
                            cw: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: (3C + 2,) float32, summed in float64."""
    logp, p, t = _softmax_onehot(x, labels)
    w = t @ cw.double()
    ll = (logp * t).sum(-1)
    return torch.cat([(p * t).sum(0), p.sum(0), t.sum(0),
                      (ll * w).sum().reshape(1), w.sum().reshape(1)]).float()


def dice_ce_bwd_reference(x: torch.Tensor, labels: torch.Tensor,
                          coef: torch.Tensor) -> torch.Tensor:
    """Plain version of K9: dlogits in float64, rounded once to x's
    dtype."""
    _, p, t = _softmax_onehot(x, labels)
    A, B, wce = coef.double().reshape(3, -1)
    q = ((A * t * p).sum(-1, keepdim=True)
         + (B * p).sum(-1, keepdim=True))
    d = (t @ wce)[:, None] * (p - t) + A * t * p + B * p - p * q
    return d.to(x.dtype).reshape(x.shape)


def _check_inputs(what: str, x: torch.Tensor, labels: torch.Tensor) -> int:
    """Raise on what K8/K9 do not take; -> C."""
    C = x.shape[-1]
    _check(1 <= C <= MAX_CLASSES,
           f"{what}: {C} classes; the kernel takes 1..{MAX_CLASSES}")
    dev = x.device
    _check(dev.type == "cuda", f"{what}: unsupported device {dev}")
    _check(x.dtype in (torch.float32, torch.bfloat16),
           f"{what}: logits dtype {x.dtype}, expected float32 or bfloat16")
    _check(x.is_contiguous(), f"{what}: logits not contiguous")
    _check(labels.device == dev and labels.dtype in (torch.int32, torch.int64)
           and labels.is_contiguous() and labels.numel() * C == x.numel(),
           f"{what}: labels {tuple(labels.shape)} {labels.dtype} on "
           f"{labels.device}; expected contiguous int32/int64 with one label "
           f"per pixel of {tuple(x.shape)} on {dev}")
    return C


class StatsPlan(NamedTuple):
    """K8's launch for one call (``stats_plan``): tiles of ``tile`` pixels
    (``tiles`` of them; the last one holds the ``P % tile`` left, if any),
    ``smem`` bytes a block (STATS_STAGES slots of logits and labels), and a
    persistent grid of ``grid`` blocks walking the tiles g, g + grid, ...
    The launch is cooperative (a grid-wide barrier between its passes), so
    ``grid`` is no larger than the blocks the card holds at once. Thread t
    of a tile adds its pixels t and t + 256 where they exist; block g
    writes row g of the (grid, 3C + 2) partials; block k (k, k + grid, ...)
    adds column k."""

    P: int
    C: int
    x_bytes: int  # bytes a logit
    lab_bytes: int  # bytes a label
    tile: int
    smem: int
    tiles: int
    grid: int

    def text(self) -> str:
        return (f"tile {self.tile} stages {STATS_STAGES} smem {self.smem} "
                f"grid {self.grid} of {self.tiles} tiles, partials "
                f"({self.grid}, {3 * self.C + 2})")


def stats_plan(P: int, C: int, x_bytes: int, lab_bytes: int, *,
               co_resident: int) -> StatsPlan:
    """K8's plan for P pixels of C classes, logits of ``x_bytes`` (2 or 4)
    and labels of ``lab_bytes`` (4 or 8); ``co_resident``: the blocks of
    its instance the card holds at once."""
    tiles = -(-P // STATS_TILE)
    smem = STATS_STAGES * STATS_TILE * (C * x_bytes + lab_bytes)
    return StatsPlan(P, C, x_bytes, lab_bytes, STATS_TILE, smem, tiles,
                     max(1, min(tiles, co_resident)))


@functools.lru_cache(maxsize=64)
def _stats_co_resident(index: int, C: int, bf16: bool, lab64: bool) -> int:
    """Blocks of K8's instance the card holds at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.lib().octseg_dice_ce_stats_resident(
            C, int(bf16), int(lab64), ctypes.addressof(n))
    _build.check(err, "dice_ce_stats occupancy")
    return n.value


def _device_index(x: torch.Tensor) -> int:
    return x.device.index if x.device.index is not None \
        else torch.cuda.current_device()


def launch_stats_plan(x: torch.Tensor, labels: torch.Tensor) -> StatsPlan:
    """The plan ``dice_ce_stats`` launches for CUDA logits and labels."""
    C = x.shape[-1]
    return stats_plan(x.numel() // C, C, x.element_size(),
                      labels.element_size(),
                      co_resident=_stats_co_resident(
                          _device_index(x), C, x.dtype == torch.bfloat16,
                          labels.dtype == torch.int64))


def dice_ce_stats(x: torch.Tensor, labels: torch.Tensor,
                  cw: torch.Tensor) -> torch.Tensor:
    """K8: (..., C) logits, labels of the leading shape, cw (C,) float32 ->
    (3C + 2,) float32 statistics. CUDA logits and labels must be 16-byte
    aligned."""
    if x.device.type == "cpu":
        return dice_ce_stats_reference(x, labels, cw)
    C = _check_inputs("dice_ce_stats", x, labels)
    dev = x.device
    _check(x.data_ptr() % 16 == 0 and labels.data_ptr() % 16 == 0,
           "dice_ce_stats: logits or labels not 16-byte aligned")
    _check_vec(cw, C, "dice_ce_stats class weights", dev)
    plan = launch_stats_plan(x, labels)
    partial = torch.empty((plan.grid, 3 * C + 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty(3 * C + 2, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_dice_ce_stats(
            x.data_ptr(), labels.data_ptr(), cw.data_ptr(),
            partial.data_ptr(), out.data_ptr(), plan.P, C,
            int(x.dtype == torch.bfloat16), int(labels.dtype == torch.int64),
            plan.grid, _stream(x))
    _build.check(err, "dice_ce_stats")
    dice_ce_stats.launches += 1
    return out


dice_ce_stats.launches = 0


class BwdPlan(NamedTuple):
    """K9's launch for one call (``bwd_plan``): tiles of ``tile`` pixels
    (``tiles`` of them; the last one holds the ``P % tile`` left, if any),
    ``smem`` bytes a block (BWD_STAGES slots of logits and labels, the
    output tile), and a persistent grid of ``grid`` blocks walking the
    tiles g, g + grid, ... Thread i of a tile computes its pixel i where
    that pixel exists."""

    P: int
    C: int
    x_bytes: int  # bytes a logit
    lab_bytes: int  # bytes a label
    tile: int
    smem: int
    tiles: int
    grid: int


def bwd_plan(P: int, C: int, x_bytes: int, lab_bytes: int, *,
             co_resident: int) -> BwdPlan:
    """K9's plan for P pixels of C classes, logits of ``x_bytes`` (2 or 4)
    and labels of ``lab_bytes`` (4 or 8); ``co_resident``: the blocks of
    its instance the card holds at once."""
    tiles = -(-P // BWD_TILE)
    smem = BWD_TILE * ((BWD_STAGES + 1) * C * x_bytes
                       + BWD_STAGES * lab_bytes)
    return BwdPlan(P, C, x_bytes, lab_bytes, BWD_TILE, smem, tiles,
                   max(1, min(tiles, co_resident)))


@functools.lru_cache(maxsize=64)
def _bwd_co_resident(index: int, C: int, bf16: bool, lab64: bool) -> int:
    """Blocks of K9's instance the card holds at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.lib().octseg_dice_ce_bwd_resident(
            C, int(bf16), int(lab64), ctypes.addressof(n))
    _build.check(err, "dice_ce_bwd occupancy")
    return n.value


def launch_plan(x: torch.Tensor, labels: torch.Tensor) -> BwdPlan:
    """The plan ``dice_ce_bwd`` launches for CUDA logits and labels."""
    C = x.shape[-1]
    return bwd_plan(x.numel() // C, C, x.element_size(),
                    labels.element_size(),
                    co_resident=_bwd_co_resident(
                        _device_index(x), C, x.dtype == torch.bfloat16,
                        labels.dtype == torch.int64))


def dice_ce_bwd(x: torch.Tensor, labels: torch.Tensor,
                coef: torch.Tensor) -> torch.Tensor:
    """K9: dlogits of x's shape and dtype from coef = [A, B, wce] (3C,)
    float32. CUDA logits and labels must be 16-byte aligned."""
    if x.device.type == "cpu":
        return dice_ce_bwd_reference(x, labels, coef)
    C = _check_inputs("dice_ce_bwd", x, labels)
    dev = x.device
    _check(x.data_ptr() % 16 == 0 and labels.data_ptr() % 16 == 0,
           "dice_ce_bwd: logits or labels not 16-byte aligned")
    _check_vec(coef, 3 * C, "dice_ce_bwd coefficients", dev)
    dx = torch.empty_like(x)
    plan = launch_plan(x, labels)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_dice_ce_bwd(
            x.data_ptr(), labels.data_ptr(), coef.data_ptr(), dx.data_ptr(),
            plan.P, C, int(x.dtype == torch.bfloat16),
            int(labels.dtype == torch.int64), plan.grid, _stream(x))
    _build.check(err, "dice_ce_bwd")
    dice_ce_bwd.launches += 1
    return dx


dice_ce_bwd.launches = 0


def stats_to_loss(stats: torch.Tensor, C: int, dice_weight: float,
                  uniform: bool, cw: torch.Tensor) -> torch.Tensor:
    """The C-sized fold of K8's statistics to the loss (``_stats_to_loss``)."""
    inter, sp, cnt = stats[:C], stats[C:2 * C], stats[2 * C:3 * C]
    sll, sw = stats[3 * C], stats[3 * C + 1]
    ce = -sll / torch.clamp_min(sw, _EPS)
    dice = (2.0 * inter + _EPS) / (sp + cnt + _EPS)
    if uniform:
        dice_term = 1.0 - torch.mean(dice)
    else:
        dice_term = 1.0 - torch.sum(dice * cw) / torch.clamp_min(
            torch.sum(cw), _EPS)
    return dice_weight * dice_term + ce


def loss_coefficients(stats: torch.Tensor, g: torch.Tensor, C: int,
                      dice_weight: float, uniform: bool,
                      cw: torch.Tensor) -> torch.Tensor:
    """[A, B, wce] (3C,) float32 for K9 from the forward's statistics and
    the loss's cotangent ``g`` (the JAX ``_bwd``)."""
    g = g.float()
    inter, sp, cnt = stats[:C], stats[C:2 * C], stats[2 * C:3 * C]
    sw = stats[3 * C + 1]
    denom = sp + cnt + _EPS
    if uniform:
        what = torch.full((C,), 1.0 / C, dtype=torch.float32,
                          device=stats.device)
    else:
        what = cw / torch.clamp_min(torch.sum(cw), _EPS)
    A = g * dice_weight * (-what * 2.0 / denom)
    B = g * dice_weight * (what * (2.0 * inter + _EPS) / (denom * denom))
    wce = g * cw / torch.clamp_min(sw, _EPS)
    return torch.cat([A, B, wce]).contiguous()


class _DiceCE(torch.autograd.Function):
    """Forward K8 + fold, backward coefficients + K9. The kernels are looked
    up by name at call time."""

    @staticmethod
    def forward(ctx, x, labels, cw, dice_weight, uniform):
        stats = dice_ce_stats(x, labels, cw)
        ctx.save_for_backward(x, labels, cw, stats)
        ctx.dice_weight, ctx.uniform = dice_weight, uniform
        return stats_to_loss(stats, x.shape[-1], dice_weight, uniform, cw)

    @staticmethod
    def backward(ctx, g):
        x, labels, cw, stats = ctx.saved_tensors
        coef = loss_coefficients(stats, g, x.shape[-1], ctx.dice_weight,
                                 ctx.uniform, cw)
        return dice_ce_bwd(x, labels, coef), None, None, None, None


def dice_ce_loss_fused(logits: torch.Tensor, labels: torch.Tensor,
                       class_weights=None, dice_weight: float = 1.0, *,
                       nchw: bool = False) -> torch.Tensor:
    """Twin of ``training/losses.dice_ce_loss`` on K8/K9: ``logits`` NHWC
    (default) or NCHW (``nchw=True``), integer (N, H, W) labels."""
    x = (logits.permute(0, 2, 3, 1) if nchw else logits).contiguous()
    C = x.shape[-1]
    uniform = class_weights is None
    cw = (torch.ones(C, dtype=torch.float32, device=x.device) if uniform
          else torch.as_tensor(class_weights, dtype=torch.float32,
                               device=x.device))
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.to(torch.int32)
    return _DiceCE.apply(x, labels.contiguous(), cw, float(dice_weight),
                         uniform)
