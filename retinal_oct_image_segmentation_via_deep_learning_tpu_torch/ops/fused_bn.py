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

``pair_sums`` runs K6 (``csrc/bn_pair_sums.cu``) for a CUDA tensor and its
plain version (float64 sums, rounded to float32) only for a CPU tensor.
"""

from __future__ import annotations

import torch

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


def pair_sums_groups(M: int, C: int) -> tuple[int, int]:
    """K6's (G, rows per block): about 2048 blocks in all, at least 64 rows
    a block."""
    channel_tiles = -(-C // 32)
    G = max(1, min(-(-M // 64), 2048 // channel_tiles))
    rows = -(-M // G)
    return -(-M // rows), rows


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
    M = a.numel() // C
    G, rows = pair_sums_groups(M, C)
    partial = torch.empty((G, 2, C), dtype=torch.float32, device=dev)
    out = torch.empty((2, C), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_bn_pair_sums(
            a.data_ptr(), None if b is None else b.data_ptr(),
            partial.data_ptr(), out.data_ptr(), M, C, G, rows,
            int(a.dtype == torch.bfloat16), _stream(a))
    _build.check(err, "pair_sums")
    pair_sums.launches += 1
    return out


pair_sums.launches = 0


def _stats(x: torch.Tensor, m: int):
    sums = pair_sums(x)
    mean = sums[0] / m
    var = torch.clamp_min(sums[1] / m - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + EPS)


class _BNTrain(torch.autograd.Function):
    """``bn_train`` with the JAX package's ``_bn_fwd`` / ``_bn_bwd``. K6 is
    looked up by name at call time."""

    @staticmethod
    def forward(ctx, x, gamma, beta):
        m = x.numel() // x.shape[-1]
        mean, var, inv = _stats(x, m)
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
        sums = pair_sums(dy, x)
        dbeta = sums[0]
        dgamma = (sums[1] - mean * dbeta) * inv
        g = gamma.float() * inv
        c1 = g * dgamma * inv / m
        c0 = g * (dbeta + dgamma * inv * (-mean)) / m
        dx = (dy.float() * g - x.float() * c1 - c0).to(x.dtype)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    """Train-mode BN over the last axis: (y in x.dtype, batch mean, biased
    batch var), flax semantics. mean and var carry no gradient."""
    return _BNTrain.apply(x, gamma, beta)
