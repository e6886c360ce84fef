"""Data: synthetic Duke-DME-shaped B-scans made on the device, and a host
loader over arrays already in memory (the JAX package's
``training/data.py``).

The synthetic generator draws from the same distributions as the JAX one
(smooth monotone layer boundaries, alternating layer reflectivity,
elliptical fluid pockets, gamma(4)/4 multiplicative speckle plus Gaussian
noise) from an explicit ``torch.Generator`` on the device. JAX's PRNG is not
reproduced, so the samples differ. ``numpy_folder_dataset`` is the JAX one
exactly, numpy shuffle included, so both trainers see the same batches in
the same order. The real-data loaders (Duke, RETOUCH, PNG volumes) are not
ported yet (ROADMAP.md, Queue A item 11).
"""

from __future__ import annotations

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticOCTConfig:
    height: int = 512
    width: int = 512
    num_layers: int = 8  # retinal layers between ILM and BM
    fluid: bool = True  # lesion pockets (class num_layers + 1)
    speckle: float = 0.35
    seed: int = 0

    @property
    def num_classes(self) -> int:
        # background + layers (+ fluid)
        return 1 + self.num_layers + (1 if self.fluid else 0)


def _uniform(g: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=g.device) * (hi - lo) + lo


def _smooth_curves(g: torch.Generator, batch: int, width: int,
                   num_layers: int, height: int) -> torch.Tensor:
    """(B, L+1, W) monotone layer boundary rows, smooth in W."""
    dev = g.device
    xs = torch.linspace(0, 2 * math.pi, width, device=dev)
    amp = _uniform(g, (batch, 1, 3), 4.0, 18.0)
    phase = _uniform(g, (batch, 1, 3), 0.0, 2 * math.pi)
    freq = torch.tensor([1.0, 2.0, 3.0], device=dev)[None, None, :]
    base = torch.sum(amp * torch.sin(freq * xs[None, :, None] + phase),
                     dim=-1)  # (B, W)
    top = height * 0.25 + base
    th = _uniform(g, (batch, num_layers), 0.5, 1.5)
    th = th / th.sum(dim=1, keepdim=True) * (height * 0.5)
    offsets = torch.cat([torch.zeros(batch, 1, device=dev),
                         torch.cumsum(th, dim=1)], dim=1)  # (B, L+1)
    return top[:, None, :] + offsets[:, :, None]


def synth_batch(g: torch.Generator, batch: int, cfg: SyntheticOCTConfig):
    """-> (images (B, H, W, 1) float32, labels (B, H, W) int64), on the
    generator's device."""
    H, W, L = cfg.height, cfg.width, cfg.num_layers
    dev = g.device
    bounds = _smooth_curves(g, batch, W, L, H)  # (B, L+1, W)
    rows = torch.arange(H, device=dev)[None, :, None, None]
    # label = boundaries at/above the row: 0 above the ILM, 1..L the
    # layers, L+1 below the BM -> background again
    above = torch.sum(rows >= bounds[:, None, :, :], dim=2)  # (B, H, W)
    labels = torch.where(above > L, 0, above)
    refl = torch.cat([torch.full((1,), 0.05, device=dev),
                      0.35 + 0.5 * (torch.arange(L, device=dev) % 2) * 0.6])
    intensity = refl[labels]
    if cfg.fluid:
        cy = _uniform(g, (batch, 1, 1), 0.45, 0.6) * H
        cx = _uniform(g, (batch, 1, 1), 0.2, 0.8) * W
        ry = _uniform(g, (batch, 1, 1), 8.0, 30.0)
        rx = ry * _uniform(g, (batch, 1, 1), 1.5, 3.0)
        yy = torch.arange(H, device=dev)[None, :, None]
        xx = torch.arange(W, device=dev)[None, None, :]
        ell = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
        fluid_mask = ell & (labels > 0) & (labels <= L)
        labels = torch.where(fluid_mask, L + 1, labels)
        intensity = torch.where(fluid_mask, 0.08, intensity)
    # gamma(4, 1) is the sum of four unit exponentials
    u = 1.0 - torch.rand((4, batch, H, W), generator=g, device=dev)
    noise = -torch.log(u).sum(dim=0) / 4.0
    img = intensity * (1.0 + cfg.speckle * (noise - 1.0))
    img = img + 0.02 * torch.randn((batch, H, W), generator=g, device=dev)
    return img[..., None].float(), labels.long()


class SyntheticOCTDataset:
    """Epoch iterator over deterministic synthetic batches made on
    ``device``: batch ``step`` of epoch ``e`` comes from a generator seeded
    with (seed, e, step)."""

    def __init__(self, cfg: SyntheticOCTConfig, num_samples: int,
                 batch_size: int, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.num_samples = num_samples
        self.batch_size = batch_size
        self.device = torch.device(device)
        self.steps_per_epoch = max(num_samples // batch_size, 1)

    def epoch(self, epoch_idx: int):
        g = torch.Generator(device=self.device)
        for step in range(self.steps_per_epoch):
            g.manual_seed(int(np.random.SeedSequence(
                [self.cfg.seed, epoch_idx, step]).generate_state(1)[0]))
            yield synth_batch(g, self.batch_size, self.cfg)


def numpy_folder_dataset(images: np.ndarray, labels: np.ndarray,
                         batch_size: int, shuffle: bool = True, seed: int = 0):
    """Host loader for data already in arrays, (N, H, W, 1) / (N, H, W):
    yields CPU tensors; the shuffle is numpy's, as in the JAX package."""
    n = images.shape[0]
    rng = np.random.default_rng(seed)
    idx = np.arange(n)

    def epoch(_epoch_idx: int):
        if shuffle:
            rng.shuffle(idx)
        for i in range(0, n - batch_size + 1, batch_size):
            sel = idx[i: i + batch_size]
            yield torch.from_numpy(images[sel]), torch.from_numpy(labels[sel])

    return SimpleNamespace(epoch=epoch, steps_per_epoch=n // batch_size)
