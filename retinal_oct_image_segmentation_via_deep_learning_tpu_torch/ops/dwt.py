"""The orthonormal 2D Haar transform of NCHW tensors (the JAX package's
``ops/dwt.py``), as reshape arithmetic in the input's dtype, with JAX's
order of operations.

pywt 'haar': low = (x_even + x_odd) / sqrt(2), high = (x_odd - x_even) /
sqrt(2); subbands (LL, LH, HL, HH), the first letter the row (height)
filter.
"""

from __future__ import annotations

import torch

_SQRT2 = 1.4142135623730951


def haar_dwt2d(x: torch.Tensor):
    """(N, C, H, W) -> (ll, lh, hl, hh), each (N, C, H/2, W/2)."""
    x0, x1 = x[..., 0::2, :], x[..., 1::2, :]
    lo_r = (x0 + x1) / _SQRT2  # low along rows (height)
    hi_r = (x1 - x0) / _SQRT2
    ll = (lo_r[..., 0::2] + lo_r[..., 1::2]) / _SQRT2
    lh = (lo_r[..., 1::2] - lo_r[..., 0::2]) / _SQRT2
    hl = (hi_r[..., 0::2] + hi_r[..., 1::2]) / _SQRT2
    hh = (hi_r[..., 1::2] - hi_r[..., 0::2]) / _SQRT2
    return ll, lh, hl, hh


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    shape = list(a.shape)
    shape[dim] *= 2
    return torch.stack([a, b], dim=dim + 1).reshape(shape)


def haar_idwt2d(ll: torch.Tensor, lh: torch.Tensor, hl: torch.Tensor,
                hh: torch.Tensor) -> torch.Tensor:
    """The inverse of ``haar_dwt2d``."""
    lo_r = _interleave((ll - lh) / _SQRT2, (ll + lh) / _SQRT2, 3)
    hi_r = _interleave((hl - hh) / _SQRT2, (hl + hh) / _SQRT2, 3)
    return _interleave((lo_r - hi_r) / _SQRT2, (lo_r + hi_r) / _SQRT2, 2)
