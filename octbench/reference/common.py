"""Pieces that the reference's models share: the per-image z-score, the
calibration batch, symmetric quantisation, the int8 epilogue and the head.

Integer products are summed in float64, which is exact here (an
accumulator stays far below 2**53), and a fused multiply-add is the
float64 ``a * b + c`` rounded once to float32 (the product of two float32
values is exact in float64).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

BN_EPS = 1e-5
ZSCORE_EPS = 1e-7


@contextlib.contextmanager
def full_float32():
    """float32 convolutions and matmuls without TF32, restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def zscore(x: torch.Tensor) -> torch.Tensor:
    """Per-image z-score of (N, H, W, 1) float32 images with the population
    std; the statistics are taken in float64 and rounded to float32."""
    xd = x.double()
    m = xd.mean(dim=(1, 2, 3), keepdim=True).float()
    s = xd.std(dim=(1, 2, 3), keepdim=True, correction=0).float()
    return (x - m) / (s + ZSCORE_EPS)


def calibration_images(image_size: int, seed: int, device) -> torch.Tensor:
    """Two seeded standard-normal images, z-scored: the batch the served
    graph's activation scales are calibrated on."""
    calib = np.random.default_rng(seed).standard_normal(
        (2, image_size, image_size, 1)).astype(np.float32)
    return zscore(torch.from_numpy(calib).to(device))


def act_scale(absmax: float, lim: int, device) -> torch.Tensor:
    """The float32 scale of a tensor whose calibrated absmax is ``absmax``,
    stored in [-lim, lim]."""
    return torch.tensor(max(absmax, 1e-12) / float(lim), dtype=torch.float32,
                        device=device)


def quant_weights(w: torch.Tensor, out_dim: int, lim: int):
    """float32 weights -> (integer weights in [-lim, lim] as float64, the
    per-output-channel float32 scale absmax/lim); ``out_dim`` is the axis
    of the output channels."""
    dims = tuple(d for d in range(w.dim()) if d != out_dim)
    amax = w.abs().amax(dim=dims)
    s_w = (amax / amax.new_full((), float(lim))).clamp_min(1e-12)
    shape = [1] * w.dim()
    shape[out_dim] = -1
    w_q = torch.round(w / s_w.view(shape)).clamp(-lim, lim)
    return w_q.double(), s_w


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``fmaf(a, b, c)``."""
    return (a.double() * b.double() + c.double()).float()


def requant(acc: torch.Tensor, scale: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """float64 integer accumulators (channels second) -> float32 value
    before rounding: ``fmaf(float32(acc), scale, bias)`` per channel."""
    shape = [1, -1] + [1] * (acc.dim() - 2)
    return fma(acc.float(), scale.view(shape), bias.view(shape))


def round_clip(v: torch.Tensor, lim: int) -> torch.Tensor:
    """float32 -> integer values (as float64): round half to even, clip."""
    return torch.round(v).clamp(-lim, lim).double()


def head_argmax(h: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """1x1 integer head and per-pixel argmax (the first maximum): (N, C, H,
    W) integer activations -> (N, H, W) int8 labels."""
    acc = torch.einsum("nchw,kc->nkhw", h, w_q.reshape(w_q.shape[0], -1))
    z = requant(acc, scale, bias)
    return z.argmax(dim=1).to(torch.int8)


def input_levels(x: torch.Tensor, s: torch.Tensor, lim: int) -> torch.Tensor:
    """z-scored (N, H, W, 1) float32 images -> (N, 1, H, W) integer levels
    at scale ``s``."""
    return round_clip(x.permute(0, 3, 1, 2) / s, lim)
