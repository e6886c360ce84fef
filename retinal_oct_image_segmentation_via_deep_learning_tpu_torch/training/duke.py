"""Duke DME .mat volume loader (Chiu et al. 2015 format; the JAX
package's ``training/duke.py``, numpy and scipy).

Each ``Subject_*.mat`` holds (H=496, W=768, B=61) arrays:
- ``images``          uint8 B-scans
- ``manualLayers1/2`` (8, W, B) row positions of the 8 layer surfaces per
  A-scan (NaN where unannotated; 11 of 61 B-scans have expert labels)
- ``manualFluid1/2``  (H, W, B) fluid annotation masks (NaN/0 background)

Labels are rasterized to per-pixel classes with the synthetic generator's
convention (``training.data``): 0 = background (vitreous above the ILM and
choroid below the last surface), 1..7 = retinal layers between
consecutive surfaces, 8 = fluid. A per-pixel validity mask marks the
A-scans whose surfaces are annotated.

Both MAT containers load: v5/v7 through ``scipy.io.loadmat``, v7.3 (HDF5,
arrays axis-reversed) through ``h5py``, imported only for such a file.
Without ``h5py`` a v7.3 file raises ``ImportError``.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np
import torch

DUKE_NUM_CLASSES = 9  # bg + 7 layers + fluid
FLUID_CLASS = 8


def _load_mat(path: str) -> dict:
    import scipy.io as sio

    try:
        return {
            k: np.asarray(v)
            for k, v in sio.loadmat(path).items()
            if not k.startswith("__")
        }
    except (NotImplementedError, ValueError):
        # MAT v7.3 = HDF5 (scipy raises NotImplementedError on real v7.3
        # files, ValueError on headerless HDF5); MATLAB order arrives
        # reversed.
        pass
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{path}: a MAT v7.3 (HDF5) file needs h5py, which is not "
            "installed; re-save it as v7 (save -v7) or install h5py"
        ) from e
    out = {}
    with h5py.File(path, "r") as f:
        for k in f.keys():
            arr = np.asarray(f[k])
            out[k] = arr.transpose(range(arr.ndim)[::-1])
    return out


def rasterize_surfaces(surfaces: np.ndarray, fluid: np.ndarray | None,
                       height: int):
    """(S, W) surface rows (+ optional (H, W) fluid mask) -> per-pixel labels.

    label(y, x) = number of surfaces at-or-above y while inside the retina
    (y in [surf_1, surf_S)); 0 outside; FLUID_CLASS where fluid. Columns with
    any NaN surface are marked invalid (labels forced 0, valid False).
    """
    S, W = surfaces.shape
    valid_cols = ~np.isnan(surfaces).any(axis=0)
    surf = np.where(valid_cols[None, :], surfaces, np.inf)
    rows = np.arange(height, dtype=np.float64)
    below = (rows.reshape(height, 1, 1) >= surf.reshape(1, S, W)).sum(axis=1)
    labels = np.where((below >= 1) & (below < S), below, 0).astype(np.int32)
    if fluid is not None:
        f = np.nan_to_num(np.asarray(fluid, np.float64)) > 0
        labels = np.where(f & valid_cols[None, :], FLUID_CLASS, labels)
    valid = np.broadcast_to(valid_cols[None, :], labels.shape)
    return labels, np.ascontiguousarray(valid)


# the published volumes annotate these 11 of their 61 B-scans
DUKE_ANNOTATED = (10, 15, 20, 25, 28, 30, 32, 35, 40, 45, 50)


def synthetic_duke_dme_volume(rng: np.random.Generator, height: int = 496,
                              width: int = 768, n_bscans: int = 61,
                              annotated=DUKE_ANNOTATED) -> dict:
    """A synthetic volume in the published Duke DME layout: the
    ``Subject_*.mat`` variables ``images`` (H, W, B) uint8,
    ``manualLayers1`` (8, W, B) float64 (NaN outside the ``annotated``
    B-scans) and ``manualFluid1`` (H, W, B) float64, drawn from ``rng``.

    Each B-scan has 8 smooth surfaces (a dark vitreous above the first),
    layers of alternating reflectivity under multiplicative speckle, and in
    the annotated B-scans an elliptical dark fluid pocket inside the
    retina. Write it with ``scipy.io.savemat(path, volume)``."""
    xs = np.linspace(0.0, 2 * np.pi, width)
    images = np.empty((height, width, n_bscans), np.uint8)
    layers = np.full((8, width, n_bscans), np.nan)
    fluid = np.zeros((height, width, n_bscans))
    refl = np.array([12, 170, 90, 200, 70, 150, 110, 220], np.float32)
    yy, xx = np.mgrid[:height, :width]
    for b in range(n_bscans):
        amp = rng.uniform(0.01 * height, 0.05 * height, 2)
        top = height * 0.25 + amp[0] * np.sin(xs + rng.uniform(0, 2 * np.pi)) \
            + amp[1] * np.sin(2 * xs + rng.uniform(0, 2 * np.pi))
        th = rng.uniform(0.5, 1.5, 7)
        th = th / th.sum() * height * 0.4
        surf = top[None, :] + np.concatenate([[0.0], np.cumsum(th)])[:, None]
        # rasterize_surfaces' labels: a row counts the surfaces at or above
        # it, i.e. at rows >= ceil(surface); below the last one is 0
        steps = np.zeros((height + 1, width), np.int32)
        for row in np.minimum(np.ceil(surf), height).astype(int):
            steps[row, np.arange(width)] += 1
        below = np.cumsum(steps[:height], axis=0)
        labels = np.where(below < 8, below, 0)
        cls = labels
        if b in annotated:
            layers[:, :, b] = surf
            cy = height * rng.uniform(0.4, 0.5)
            cx = width * rng.uniform(0.3, 0.7)
            ry = height * rng.uniform(0.02, 0.05)
            rx = ry * rng.uniform(1.5, 3.0)
            pocket = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0) \
                & (labels > 0)
            fluid[:, :, b] = pocket
            cls = np.where(pocket, 0, labels)
        speckle = rng.standard_normal((height, width), dtype=np.float32)
        img = refl[cls] * (1.0 + 0.3 * speckle)
        images[:, :, b] = np.clip(img, 0, 255).astype(np.uint8)
    return {"images": images, "manualLayers1": layers,
            "manualFluid1": fluid}


def load_duke_dme_volume(path: str, annotator: int = 1):
    """-> (images (B, H, W, 1) float32 in [0,1], labels (B, H, W) int32,
    valid (B, H, W) bool). B iterates the volume's B-scans; only annotated
    slices carry nonzero ``valid``."""
    mat = _load_mat(path)
    images = np.asarray(mat["images"], np.float32) / 255.0  # (H, W, B)
    layers = np.asarray(mat[f"manualLayers{annotator}"], np.float64)
    fluid = mat.get(f"manualFluid{annotator}")
    H, W, B = images.shape
    labels = np.zeros((B, H, W), np.int32)
    valid = np.zeros((B, H, W), bool)
    for b in range(B):
        if np.isnan(layers[:, :, b]).any(axis=0).all():
            continue  # no annotated A-scan: labels 0, valid False
        fl = None if fluid is None else np.asarray(fluid, np.float64)[:, :, b]
        labels[b], valid[b] = rasterize_surfaces(layers[:, :, b], fl, H)
    # C order (scipy reads MATLAB's Fortran order)
    return np.ascontiguousarray(images.transpose(2, 0, 1)[..., None]), \
        labels, valid


def annotated_slices(labels: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """Indices of B-scans that carry any annotation."""
    return np.nonzero(valid.any(axis=(1, 2)))[0]


class DukeDMEDataset:
    """Epoch iterator over annotated Duke DME B-scans from a directory of
    ``Subject_*.mat`` files. Crops/pads to ``image_size`` (H, W) top-left;
    yields (images, labels) CPU tensors, the Trainer's batch contract."""

    def __init__(self, root: str, batch_size: int = 8,
                 image_size: tuple[int, int] | None = None,
                 annotator: int = 1, shuffle: bool = True, seed: int = 0):
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        imgs, labs = [], []
        files = sorted(
            f for f in os.listdir(root) if f.lower().endswith(".mat")
        )
        if not files:
            raise FileNotFoundError(f"no .mat volumes under {root}")
        for f in files:
            images, labels, valid = load_duke_dme_volume(
                os.path.join(root, f), annotator
            )
            for b in annotated_slices(labels, valid):
                img, lab = images[b], labels[b]
                if image_size is not None:
                    th, tw = image_size
                    img = img[:th, :tw]
                    lab = lab[:th, :tw]
                    ph, pw = th - img.shape[0], tw - img.shape[1]
                    if ph > 0 or pw > 0:
                        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
                        lab = np.pad(lab, ((0, ph), (0, pw)))
                imgs.append(img)
                labs.append(lab)
        self.images = np.ascontiguousarray(np.stack(imgs))
        self.labels = np.ascontiguousarray(np.stack(labs))
        self.steps_per_epoch = max(len(self.images) // batch_size, 1)

    def epoch(self, epoch_idx: int) -> Iterator[tuple]:
        idx = np.arange(len(self.images))
        if self.shuffle:
            self.rng.shuffle(idx)
        for s in range(self.steps_per_epoch):
            sel = idx[s * self.batch_size : (s + 1) * self.batch_size]
            yield (torch.from_numpy(self.images[sel]),
                   torch.from_numpy(self.labels[sel]))
