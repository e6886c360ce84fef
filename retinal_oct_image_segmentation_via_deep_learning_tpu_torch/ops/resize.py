"""Resizes with torch ``interpolate``'s sampling grids (the JAX package's
``ops/resize.py``): ``resize_nearest``, ``resize_bilinear`` and
``upsample`` on NHWC tensors, and SDNet's ``upsample_bilinear`` on NCHW.

Output pixel d of a side of n_in pixels resized to n_out samples the input
at
- nearest:                  src = floor(d * n_in / n_out)
- bilinear, align=False:    src = (d + 0.5) * n_in / n_out - 0.5, clamped
- bilinear, align=True:     src = d * (n_in - 1) / (n_out - 1)

The source coordinates are computed in float32, as JAX computes them
(x64 off): a double would pick another neighbour at some sizes. A bilinear
resize is two one-dimensional gathers, each followed by a lerp
``a + (b - a) * w``: rows first, then columns, JAX's order of float
operations.
"""

from __future__ import annotations

import torch


def _nearest_indices(out_size: int, in_size: int, device) -> torch.Tensor:
    dst = torch.arange(out_size, dtype=torch.float32, device=device)
    idx = torch.floor(dst * (in_size / out_size)).long()
    return idx.clamp(0, in_size - 1)


def resize_nearest(x: torch.Tensor, out_hw) -> torch.Tensor:
    """NHWC nearest resize, as ``interpolate(mode='nearest')``."""
    ri = _nearest_indices(out_hw[0], x.shape[-3], x.device)
    ci = _nearest_indices(out_hw[1], x.shape[-2], x.device)
    return x[..., ri, :, :][..., ci, :]


def _linear_weights(out_size: int, in_size: int, align_corners: bool,
                    device):
    """(lo, hi, w_hi): the two source indices of each output and the
    weight of ``hi``."""
    if out_size == 1:
        # one output samples src 0 (align) or the centre (not align)
        src = torch.zeros(1, device=device)
        if not align_corners:
            src = torch.full((1,), 0.5 * (in_size / out_size) - 0.5,
                             device=device)
    else:
        dst = torch.arange(out_size, dtype=torch.float32, device=device)
        if align_corners:
            src = dst * ((in_size - 1) / (out_size - 1))
        else:
            src = (dst + 0.5) * (in_size / out_size) - 0.5
    src = torch.clamp(src, 0.0, in_size - 1)
    lo = torch.floor(src).long()
    hi = torch.clamp_max(lo + 1, in_size - 1)
    return lo, hi, src - lo


def resize_bilinear(x: torch.Tensor, out_hw,
                    align_corners: bool = False) -> torch.Tensor:
    """NHWC bilinear resize, as ``interpolate(mode='bilinear')``; computed
    in float32, returned in x's dtype."""
    xf = x.float()
    rlo, rhi, rw = _linear_weights(out_hw[0], x.shape[-3], align_corners,
                                   x.device)
    clo, chi, cw = _linear_weights(out_hw[1], x.shape[-2], align_corners,
                                   x.device)
    top, bot = xf[..., rlo, :, :], xf[..., rhi, :, :]
    xf = top + (bot - top) * rw[:, None, None]
    left, right = xf[..., clo, :], xf[..., chi, :]
    return (left + (right - left) * cw[:, None]).to(x.dtype)


def upsample(x: torch.Tensor, scale: int = 2, mode: str = "nearest",
             align_corners: bool = False) -> torch.Tensor:
    """Integer-factor NHWC upsample with torch's sampling."""
    out_hw = (x.shape[-3] * scale, x.shape[-2] * scale)
    if mode == "nearest":
        return resize_nearest(x, out_hw)
    if mode == "bilinear":
        return resize_bilinear(x, out_hw, align_corners)
    raise ValueError(f"unknown mode {mode}")


def upsample_bilinear(x: torch.Tensor, scale: int = 2) -> torch.Tensor:
    """Integer-factor (``scale`` >= 2) bilinear upsample of an NCHW tensor,
    as ``interpolate(mode='bilinear', align_corners=True)``; computed in
    float32, returned in x's dtype."""
    if scale < 2:
        raise ValueError(f"upsample_bilinear: scale {scale}, expected >= 2")
    xf = x.float()
    rlo, rhi, rw = _linear_weights(x.shape[-2] * scale, x.shape[-2], True,
                                   x.device)
    clo, chi, cw = _linear_weights(x.shape[-1] * scale, x.shape[-1], True,
                                   x.device)
    top, bot = xf[..., rlo, :], xf[..., rhi, :]
    xf = top + (bot - top) * rw[:, None]
    left, right = xf[..., clo], xf[..., chi]
    return (left + (right - left) * cw).to(x.dtype)
