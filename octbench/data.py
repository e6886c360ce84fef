"""Seeded synthetic Duke-DME-shaped B-scans, made on the device.

A copy of the program's generator (``training/data.synth_batch``): smooth
monotone layer boundaries, alternating layer reflectivity, an elliptical
fluid pocket, gamma(4)/4 multiplicative speckle and Gaussian noise. The
benchmark keeps its own copy so that its inputs do not move when the
program's generator does.

A traffic mix may ask for rows that differ as scans of different
patients and devices do (``variety``): each row then draws its speckle
contrast, additive noise, the retina's top and its thickness (shares of
the image height) from the ranges given, where the program's generator
fixes them at 0.35, 0.02, 0.25 and 0.5.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


# the program generator's fixed values of what ``variety`` draws per row
FIXED = {"speckle": 0.35, "noise": 0.02, "retina_top": 0.25,
         "retina_thickness": 0.5}


def _per_row(g: torch.Generator, n: int, variety: dict | None, key: str,
             ndim: int) -> torch.Tensor | float:
    """``key``'s value: drawn for each of the ``n`` rows from its range in
    ``variety`` (shaped to broadcast over ``ndim`` dimensions), or fixed."""
    if not variety:
        return FIXED[key]
    lo, hi = variety[key]
    return _uniform(g, (n,) + (1,) * (ndim - 1), lo, hi)


def _boundaries(g: torch.Generator, n: int, width: int, layers: int,
                height: int, variety: dict | None = None) -> torch.Tensor:
    """(n, layers + 1, W) monotone layer boundary rows, smooth in W."""
    dev = g.device
    xs = torch.linspace(0, 2 * math.pi, width, device=dev)
    amp = _uniform(g, (n, 1, 3), 4.0, 18.0)
    phase = _uniform(g, (n, 1, 3), 0.0, 2 * math.pi)
    freq = torch.tensor([1.0, 2.0, 3.0], device=dev)[None, None, :]
    base = torch.sum(amp * torch.sin(freq * xs[None, :, None] + phase),
                     dim=-1)
    top = height * _per_row(g, n, variety, "retina_top", 2) + base
    th = _uniform(g, (n, layers), 0.5, 1.5)
    th = th / th.sum(dim=1, keepdim=True) * (
        height * _per_row(g, n, variety, "retina_thickness", 2))
    offsets = torch.cat([torch.zeros(n, 1, device=dev),
                         torch.cumsum(th, dim=1)], dim=1)
    return top[:, None, :] + offsets[:, :, None]


def bscans(g: torch.Generator, n: int, side: int, num_classes: int,
           variety: dict | None = None):
    """-> (images (n, side, side) float32, labels (n, side, side) int64) on
    the generator's device: ``num_classes - 2`` layers, background above
    and below, and fluid (the last class)."""
    H = W = side
    L = num_classes - 2
    dev = g.device
    bounds = _boundaries(g, n, W, L, H, variety)
    rows = torch.arange(H, device=dev)[None, :, None, None]
    above = torch.sum(rows >= bounds[:, None, :, :], dim=2)
    labels = torch.where(above > L, 0, above)
    refl = torch.cat([torch.full((1,), 0.05, device=dev),
                      0.35 + 0.5 * (torch.arange(L, device=dev) % 2) * 0.6])
    intensity = refl[labels]
    cy = _uniform(g, (n, 1, 1), 0.45, 0.6) * H
    cx = _uniform(g, (n, 1, 1), 0.2, 0.8) * W
    ry = _uniform(g, (n, 1, 1), 8.0, 30.0)
    rx = ry * _uniform(g, (n, 1, 1), 1.5, 3.0)
    yy = torch.arange(H, device=dev)[None, :, None]
    xx = torch.arange(W, device=dev)[None, None, :]
    fluid = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0) & \
        (labels > 0) & (labels <= L)
    labels = torch.where(fluid, L + 1, labels)
    intensity = torch.where(fluid, 0.08, intensity)
    # gamma(4, 1) is the sum of four unit exponentials
    u = 1.0 - torch.rand((4, n, H, W), generator=g, device=dev)
    noise = -torch.log(u).sum(dim=0) / 4.0
    speckle = _per_row(g, n, variety, "speckle", 3)
    sigma = _per_row(g, n, variety, "noise", 3)
    img = intensity * (1.0 + speckle * (noise - 1.0))
    img = img + sigma * torch.randn((n, H, W), generator=g, device=dev)
    return img.float(), labels


def make_rows(seed: int, n: int, side: int, num_classes: int, device,
              grey_gain: float | None = None, labels: bool = True,
              block: int = 64, variety: dict | None = None):
    """``n`` seeded B-scans and label maps on the host, made on ``device``
    in blocks of ``block``: (images (n, side, side), labels (n, side, side)
    int32). The images are float32, or with ``grey_gain`` uint8 grey
    levels (``grey_gain`` levels a unit of reflectivity, clipped to [0,
    255]); without ``labels``, labels is None. ``variety``: the ranges
    that each row draws from (the module docstring), or None."""
    g = torch.Generator(device=device).manual_seed(seed)
    images = np.empty((n, side, side), np.uint8 if grey_gain else np.float32)
    out = np.empty((n, side, side), np.int32) if labels else None
    for i in range(0, n, block):
        m = min(block, n - i)
        img, lab = bscans(g, m, side, num_classes, variety)
        if grey_gain:
            img = (img * grey_gain).round_().clamp_(0, 255).to(torch.uint8)
        images[i:i + m] = img.cpu().numpy()
        if labels:
            out[i:i + m] = lab.to(torch.int32).cpu().numpy()
    return images, out
