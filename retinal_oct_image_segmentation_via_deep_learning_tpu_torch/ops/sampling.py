"""Bilinear grid sampling and the FFC stack's rotation (the JAX package's
``ops/sampling.py``) on NCHW tensors, in plain PyTorch.

``reference_rotate`` is the reference's ``rotate``
(``Lesions_Segment/YNet_2022.py:36-75``), quirk included: the sampling
grid is built over a transposed meshgrid, point p = i*H + j at
(x = lin_w[i], y = lin_h[j]), and the flat (W*H, 2) buffer is then read as
(H, W, 2). ``grid_sample_bilinear`` is a pair of gathers and lerps in the
JAX function's order of float operations, with torch ``grid_sample``'s
reflection folding, or JAX's zero padding (the whole sample zeroed where
the point lies more than one pixel outside the map; the corners inside are
clamped, not masked one by one), and either corner convention; it is held
to the JAX function, not to ``F.grid_sample``.
"""

from __future__ import annotations

import math

import torch


def _reflect_coord(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Reflect x into [lo, hi] (torch 'reflection', align_corners=True)."""
    span = hi - lo
    if span == 0:
        return torch.zeros_like(x)
    x = torch.remainder(torch.abs(x - lo), 2 * span)
    return hi - torch.abs(x - span)


def grid_sample_bilinear(x: torch.Tensor, grid: torch.Tensor,
                         padding_mode: str = "reflection",
                         align_corners: bool = True) -> torch.Tensor:
    """Bilinear sample of an (N, C, H, W) tensor at ``grid`` (N, Ho, Wo, 2),
    last dim (gx, gy) in [-1, 1] -> (N, C, Ho, Wo). ``padding_mode``
    "reflection" folds the coordinates into the map, "zeros" gives 0 where
    a point lies outside [-1, W] x [-1, H] (pixel units), as JAX's;
    ``align_corners`` maps -1 and 1 to the centres of the corner pixels
    (True) or to their outer edges (False)."""
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        ix = (gx + 1.0) * 0.5 * (W - 1)
        iy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        ix = ((gx + 1.0) * W - 1.0) * 0.5
        iy = ((gy + 1.0) * H - 1.0) * 0.5
    if padding_mode == "reflection":
        ix = _reflect_coord(ix, 0.0, float(W - 1))
        iy = _reflect_coord(iy, 0.0, float(H - 1))

    x0 = torch.floor(ix)
    y0 = torch.floor(iy)
    wx = (ix - x0).unsqueeze(1)
    wy = (iy - y0).unsqueeze(1)
    flat = x.reshape(N, C, H * W)

    def gather(yy, xx):
        yy = torch.clamp(yy, 0, H - 1).long()
        xx = torch.clamp(xx, 0, W - 1).long()
        idx = (yy * W + xx).reshape(N, 1, -1).expand(N, C, -1)
        return torch.gather(flat, 2, idx).reshape((N, C) + yy.shape[1:])

    v00 = gather(y0, x0)
    v01 = gather(y0, x0 + 1)
    v10 = gather(y0 + 1, x0)
    v11 = gather(y0 + 1, x0 + 1)
    top = v00 + (v01 - v00) * wx
    bot = v10 + (v11 - v10) * wx
    out = top + (bot - top) * wy
    if padding_mode == "zeros":
        valid = (ix >= -1) & (ix <= W) & (iy >= -1) & (iy <= H)
        out = torch.where(valid.unsqueeze(1), out, 0.0)
    return out


def _linspace(n: int, device) -> torch.Tensor:
    """``jnp.linspace(-1, 1, n)`` in float32: -1 * (1 - t) + 1 * t at
    t = i / (n - 1), the last point exactly 1."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    out = -1.0 * (1 - t) + 1.0 * t
    return torch.cat([out, torch.ones(1, device=device)])


def reference_rotate(x: torch.Tensor, angle_degrees) -> torch.Tensor:
    """Rotate an (N, C, H, W) tensor by ``angle_degrees`` (a float32 scalar
    tensor, or a float) as the reference's ``rotate`` does, its
    transposed-meshgrid grid included."""
    N, C, H, W = x.shape
    angle = torch.as_tensor(angle_degrees, dtype=torch.float32,
                            device=x.device)
    theta = angle * math.pi / 180.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    lin_w = _linspace(W, x.device)
    lin_h = _linspace(H, x.device)
    px = lin_w.repeat_interleave(H)
    py = lin_h.repeat(W)
    rx = cos * px - sin * py
    ry = sin * px + cos * py
    grid = torch.stack([rx, ry], dim=1).reshape(H, W, 2)
    grid = grid.unsqueeze(0).expand(N, H, W, 2)
    return grid_sample_bilinear(x.float(), grid).to(x.dtype)
