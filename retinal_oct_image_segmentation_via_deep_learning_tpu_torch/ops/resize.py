"""Bilinear upsampling with torch ``interpolate``'s ``align_corners=True``
grid (the JAX package's ``ops/resize.py``), on NCHW tensors.

Output pixel d of a side of n_in pixels upsampled to n_out samples the
input at src = d * (n_in - 1) / (n_out - 1). The resize is two
one-dimensional gathers, each followed by a lerp ``a + (b - a) * w``: rows
first, then columns, the JAX package's order of float operations.
"""

from __future__ import annotations

import torch


def _linear_weights(out_size: int, in_size: int, device):
    """(lo, hi, w_hi): the two source indices of each output and the
    weight of ``hi``."""
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    src = torch.clamp(dst * ((in_size - 1) / (out_size - 1)), 0.0,
                      in_size - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp_max(lo + 1, in_size - 1)
    return lo, hi, src - lo


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Integer-factor (``scale`` >= 2) bilinear upsample of an NCHW tensor,
    as ``interpolate(mode='bilinear', align_corners=True)``; computed in
    float32, returned in x's dtype."""
    if scale < 2:
        raise ValueError(f"upsample_bilinear: scale {scale}, expected >= 2")
    xf = x.float()
    rlo, rhi, rw = _linear_weights(x.shape[-2] * scale, x.shape[-2], x.device)
    clo, chi, cw = _linear_weights(x.shape[-1] * scale, x.shape[-1], x.device)
    top, bot = xf[..., rlo, :], xf[..., rhi, :]
    xf = top + (bot - top) * rw[:, None]
    left, right = xf[..., clo], xf[..., chi]
    return (left + (right - left) * cw).to(x.dtype)
