"""Folder reads of the reference's FourierNet pipeline
(``SOTAS/Layers_Segment/FourierNet/trainTestModels.py``), the part of the
JAX package's ``training/fouriernet_pipeline.py`` that ``cli infer
--image-dir`` reads: the per-image z-score, the sorted image listing and
the folder read. FourierNet's train and test loops come with the model.
"""

from __future__ import annotations

import os

import numpy as np

from .png_volumes import _imread


def zscore_image(img: np.ndarray) -> np.ndarray:
    """Per-image z-score (reference ``readOneImage``, :17)."""
    return (img - img.mean()) / (img.std() + 1e-7)


def list_image_files(directory: str) -> list[str]:
    """Sorted image filenames in a directory (reference
    ``listAllImageFiles``, :62-69)."""
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
    return sorted(
        f for f in os.listdir(directory) if f.lower().endswith(exts)
    )


def read_folder_dataset(image_dir: str, gold_dir: str | None = None):
    """-> (images (N, H, W) float32 grey levels, masks (N, H, W) uint8 in
    {0, 1} or None, names): the reference's ``readOneDataset`` flow
    (:38-59); gold masks are binarized (:31-34). Images are read with cv2,
    else PIL."""
    names = list_image_files(image_dir)
    images, masks = [], []
    for n in names:
        images.append(_imread(os.path.join(image_dir, n)).astype(np.float32))
        if gold_dir is not None:
            gold = _imread(os.path.join(gold_dir, n))
            masks.append((gold > 0).astype(np.uint8))
    images = np.stack(images)
    masks = np.stack(masks) if masks else None
    return images, masks, names
