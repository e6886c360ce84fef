"""Data: synthetic Duke-DME-shaped B-scans made on the device, a host
loader over arrays already in memory, and the dataset-spec dispatcher
over the real-data loaders (the JAX package's ``training/data.py``).

The synthetic generator draws from the same distributions as the JAX one
(smooth monotone layer boundaries, alternating layer reflectivity,
elliptical fluid pockets, gamma(4)/4 multiplicative speckle plus Gaussian
noise) from an explicit ``torch.Generator`` on the device. JAX's PRNG is not
reproduced, so the samples differ. ``numpy_folder_dataset`` is the JAX one
exactly, numpy shuffle included, so both trainers see the same batches in
the same order. ``load_real_dataset`` and ``make_datasets`` read a spec
``duke:<dir>``, ``retouch:<dir>`` or ``png:<dir>`` through ``duke.py``,
``retouch.py`` or ``png_volumes.py`` and split whole volumes off for
validation, as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math
import os
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


# ---------------------------------------------------------------------------
# dataset spec dispatcher: one string selects synthetic or a real-data loader
# ---------------------------------------------------------------------------


def _crop_pad(img: np.ndarray, lab: np.ndarray, size):
    """Crop or zero-pad (H, W[, C]) ``img`` and (H, W) ``lab`` top-left to
    ``size``."""
    th, tw = size
    img, lab = img[:th, :tw], lab[:th, :tw]
    ph, pw = th - img.shape[0], tw - img.shape[1]
    if ph > 0 or pw > 0:
        img = np.pad(img, ((0, ph), (0, pw)) + ((0, 0),) * (img.ndim - 2))
        lab = np.pad(lab, ((0, ph), (0, pw)))
    return img, lab


def load_real_dataset(spec: str, image_size, return_volumes: bool = False):
    """'duke:<dir>' | 'retouch:<dir>' | 'png:<dir>' ->
    (images (N, H, W, 1) float32, labels (N, H, W) int32, num_classes[,
    vol_ids]).

    Only labeled B-scans are kept; volumes are flattened into one B-scan
    pool, cropped or padded top-left to ``image_size`` (the Duke
    convention). With ``return_volumes=True`` also a per-B-scan int volume
    id, so callers can split train/val at volume granularity.
    """
    kind, _, root = spec.partition(":")
    if not root:
        raise ValueError(f"dataset spec needs a path: '{spec}'")
    imgs, labs, vols = [], [], []
    if kind == "duke":
        from .duke import annotated_slices, load_duke_dme_volume

        files = sorted(
            f for f in os.listdir(root) if f.lower().endswith(".mat")
        )
        for v, f in enumerate(files):
            images, labels, valid = load_duke_dme_volume(
                os.path.join(root, f)
            )
            for b in annotated_slices(labels, valid):
                imgs.append(images[b])
                labs.append(labels[b])
                vols.append(v)
    elif kind == "retouch":
        from .retouch import iter_cases

        for v, case in enumerate(iter_cases(root)):
            if case["labels"] is None:
                continue
            for b in range(case["images"].shape[0]):
                imgs.append(case["images"][b][..., None])
                labs.append(case["labels"][b])
                vols.append(v)
    elif kind == "png":
        from .png_volumes import iter_png_volumes

        for v, vol in enumerate(iter_png_volumes(root)):
            if vol["labels"] is None:
                continue
            for b in range(vol["images"].shape[0]):
                imgs.append(vol["images"][b])
                labs.append(vol["labels"][b])
                vols.append(v)
    else:
        raise ValueError(f"unknown dataset kind '{kind}'")
    if not imgs:
        raise FileNotFoundError(f"no labeled B-scans under {root}")
    pairs = [_crop_pad(i, l, image_size) for i, l in zip(imgs, labs)]
    # C order: scipy reads MATLAB arrays in Fortran order, and the CUDA
    # kernels take contiguous tensors only
    images = np.ascontiguousarray(np.stack([p[0] for p in pairs]),
                                  np.float32)
    labels = np.ascontiguousarray(np.stack([p[1] for p in pairs]), np.int32)
    out = (images, labels, int(labels.max()) + 1)
    return out + (np.asarray(vols),) if return_volumes else out


def make_datasets(spec: str | None, image_size, batch_size: int,
                  val_fraction: float = 0.1, seed: int = 0):
    """-> (train_ds, val_ds, num_classes), or None for a synthetic spec
    (the caller builds the synthetic datasets).

    The validation split holds out WHOLE volumes (the last volumes until
    they hold >= ``val_fraction`` of the B-scans, or a batch), so that
    near-duplicate B-scans of one volume never straddle the split; with a
    single volume it falls back to a B-scan index split.
    """
    if spec in (None, "", "synthetic", "synthetic_duke_dme"):
        return None
    images, labels, num_classes, vols = load_real_dataset(
        spec, image_size, return_volumes=True
    )
    n = images.shape[0]
    n_val = max(int(n * val_fraction), min(batch_size, n // 2))
    unique_vols = np.unique(vols)
    if len(unique_vols) > 1:
        counts = {v: int(np.sum(vols == v)) for v in unique_vols}
        val_vols, acc = [], 0
        for v in unique_vols[::-1]:
            if acc >= n_val or len(val_vols) >= len(unique_vols) - 1:
                break
            val_vols.append(v)
            acc += counts[v]
        is_val = np.isin(vols, val_vols)
    else:
        is_val = np.arange(n) >= n - n_val
    train = numpy_folder_dataset(
        images[~is_val], labels[~is_val], batch_size, seed=seed
    )
    val = numpy_folder_dataset(
        images[is_val], labels[is_val], batch_size, shuffle=False
    )
    return train, val, num_classes
