"""Paired-PNG volume loader (AROI-style layout: per-volume image/mask
dirs; the JAX package's ``training/png_volumes.py``).

Several public layer-segmentation datasets (AROI, OCT5K, the reference's
FourierNet data layout, ``trainTestModels.py:38-59``) ship as folders of
per-B-scan PNGs with a parallel folder of mask PNGs. This loader pairs
them by filename stem, stacks a volume, and maps mask pixel values to
contiguous class ids:

* grayscale masks whose values already are class ids: pass
  ``value_map=None`` (ids are compacted to 0..K-1 in sorted-value order);
* color- or level-coded masks (e.g. AROI encodes 8 classes as gray
  levels): pass ``value_map={pixel_value: class_id}``.

Returns float32 images in [0, 1] shaped (B, H, W, 1) + int32 labels
(B, H, W). Images are read with ``cv2``, else ``PIL``; without either,
reading raises ``ImportError``.
"""

from __future__ import annotations

import os
from typing import Iterator, Mapping

import numpy as np


def _imread(path: str, grayscale: bool = True) -> np.ndarray:
    """One image as a uint8 array, through cv2 or else PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        flag = cv2.IMREAD_GRAYSCALE if grayscale else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{path}: reading images needs cv2 (opencv-python) or PIL "
            "(pillow), and neither is installed") from e
    with Image.open(path) as img:
        return np.asarray(img.convert("L") if grayscale else img)


def _stems(directory: str) -> dict[str, str]:
    out = {}
    for name in sorted(os.listdir(directory)):
        stem, ext = os.path.splitext(name)
        if ext.lower() in (".png", ".bmp", ".tif", ".tiff", ".jpg", ".jpeg"):
            out[stem] = os.path.join(directory, name)
    return out


def load_png_volume(image_dir: str, mask_dir: str | None = None,
                    value_map: Mapping[int, int] | None = None,
                    match: str = "stem"):
    """-> (images (B, H, W, 1) float32, labels (B, H, W) int32 | None,
    stems list).

    ``match="stem"`` pairs by identical filename stem; ``match="order"``
    pairs the sorted listings positionally (AROI raw/mask names differ by a
    ``raw``/``mask`` infix, so stems don't collide there).
    """
    imgs = _stems(image_dir)
    stems = list(imgs)
    images = np.stack([
        _imread(imgs[s]).astype(np.float32) / 255.0 for s in stems
    ])[..., None]
    labels = None
    if mask_dir is not None:
        masks = _stems(mask_dir)
        if match == "stem":
            missing = [s for s in stems if s not in masks]
            if missing:
                raise FileNotFoundError(
                    f"masks missing for {missing[:3]}... in {mask_dir}"
                )
            mpaths = [masks[s] for s in stems]
        else:
            mlist = list(masks.values())
            if len(mlist) != len(stems):
                raise ValueError(
                    f"{len(stems)} images vs {len(mlist)} masks"
                )
            mpaths = mlist
        raw = np.stack([_imread(p) for p in mpaths]).astype(np.int64)
        if value_map is not None:
            lut = np.zeros(256, np.int32)
            for value, cls in value_map.items():
                lut[value] = cls
            labels = lut[raw]
        else:
            values = np.unique(raw)
            lut = np.zeros(int(values.max()) + 1, np.int32)
            lut[values] = np.arange(len(values), dtype=np.int32)
            labels = lut[raw]
    return images, labels, stems


def _volume_dirs(root: str, image_sub: str, mask_sub: str):
    for name in sorted(os.listdir(root)):
        vdir = os.path.join(root, name)
        idir = os.path.join(vdir, image_sub)
        if not os.path.isdir(idir):
            continue
        mdir = os.path.join(vdir, mask_sub)
        yield name, idir, (mdir if os.path.isdir(mdir) else None)


def scan_mask_values(root: str, image_sub: str = "raw",
                     mask_sub: str = "mask") -> Mapping[int, int]:
    """Global pixel-value -> class-id map over EVERY mask under ``root``.

    With ``value_map=None`` a per-volume ``np.unique`` compaction would map
    the same mask value to different class ids whenever a volume is missing
    a class (silent label corruption across volumes); this pre-scan builds
    one consistent map from the union of values, in sorted-value order.
    """
    values: set[int] = set()
    for _name, _idir, mdir in _volume_dirs(root, image_sub, mask_sub):
        if mdir is None:
            continue
        for path in _stems(mdir).values():
            values.update(int(v) for v in np.unique(_imread(path)))
    return {v: i for i, v in enumerate(sorted(values))}


def iter_png_volumes(root: str, image_sub: str = "raw",
                     mask_sub: str = "mask",
                     value_map: Mapping[int, int] | None = None,
                     match: str = "order") -> Iterator[dict]:
    """Yield AROI-style per-volume dicts from ``root/<vol>/{raw,mask}/``.

    When ``value_map`` is None, a global map is pre-scanned across all
    volumes (``scan_mask_values``) so class ids are consistent even when
    individual volumes are missing classes.
    """
    if value_map is None:
        value_map = scan_mask_values(root, image_sub, mask_sub) or None
    for name, idir, mdir in _volume_dirs(root, image_sub, mask_sub):
        images, labels, stems = load_png_volume(
            idir, mdir, value_map, match
        )
        yield {"volume": name, "images": images, "labels": labels,
               "stems": stems}
