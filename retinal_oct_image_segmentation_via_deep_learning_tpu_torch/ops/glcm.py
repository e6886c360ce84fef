"""GLCM (gray-level co-occurrence matrix) texture features on the device
(the JAX package's ``ops/glcm.py``; reference ``Masood_2024.py:73-144``).

As skimage's ``graycomatrix(img, [d], [angle], levels=256,
symmetric=True, normed=True)`` on the reference's grid: offsets
``(round(sin(a) d), round(cos(a) d))`` with the angles {0, 90, -45, -135}
read as radians (as skimage reads them, and as the reference passes
them), distances 1 and 2. An image is min-max normalised and truncated to
256 levels in float32 (``quantize_reference``); a matrix is an exact count
(``torch.bincount``), symmetrised and normalised. The eight properties
(contrast, dissimilarity, homogeneity, energy, correlation, ASM, entropy
in log2, the row-index variance) are float32 sums over its 65,536 cells.
"""

from __future__ import annotations

import numpy as np
import torch

LEVELS = 256
REFERENCE_ANGLES = (0.0, 90.0, -45.0, -135.0)  # radians, per the reference
REFERENCE_DISTANCES = (1, 2)


def reference_offsets():
    """(row, col) offsets for the reference's angle/distance grid."""
    offs = []
    for a in REFERENCE_ANGLES:
        for d in REFERENCE_DISTANCES:
            offs.append(
                (int(round(np.sin(a) * d)), int(round(np.cos(a) * d)))
            )
    return offs


def quantize_reference(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float32 -> int32 levels, per image: (img - lo) / (hi - lo
    + 1e-8) * 255, truncated. The divisor is a tensor on img's device, so
    that the division is IEEE division on the card too (by a Python
    scalar CUDA multiplies by its reciprocal)."""
    lo = img.amin(dim=(1, 2), keepdim=True)
    hi = img.amax(dim=(1, 2), keepdim=True)
    return ((img - lo) / (hi - lo + 1e-8) * 255).to(torch.int32)


def glcm_counts(q: torch.Tensor, row_off: int, col_off: int) -> torch.Tensor:
    """(B, H, W) int32 levels -> (B, 256, 256) float32 counts of the level
    pairs (q[r, c], q[r + row_off, c + col_off]) over the pixels where both
    lie in the image."""
    B, H, W = q.shape
    r0, r1 = max(0, -row_off), H - max(0, row_off)
    c0, c1 = max(0, -col_off), W - max(0, col_off)
    a = q[:, r0:r1, c0:c1].long()
    b = q[:, r0 + row_off:r1 + row_off, c0 + col_off:c1 + col_off].long()
    image = torch.arange(B, device=q.device).view(B, 1, 1)
    idx = (image * LEVELS + a) * LEVELS + b
    hist = torch.bincount(idx.reshape(-1), minlength=B * LEVELS * LEVELS)
    return hist.float().view(B, LEVELS, LEVELS)


def glcm_single(q: torch.Tensor, row_off: int,
                col_off: int) -> torch.Tensor:
    """The normalised symmetric co-occurrence matrices (B, 256, 256) of
    one offset."""
    glcm = glcm_counts(q, row_off, col_off)
    glcm = glcm + glcm.transpose(1, 2)  # symmetric=True
    return glcm / glcm.sum(dim=(1, 2), keepdim=True).clamp_min(1.0)


def glcm_properties(glcm: torch.Tensor) -> torch.Tensor:
    """(..., 256, 256) -> (..., 8): contrast, dissimilarity, homogeneity,
    energy, correlation, ASM, entropy, variance."""
    i = torch.arange(LEVELS, dtype=torch.float32, device=glcm.device)
    ii, jj = i.view(-1, 1), i.view(1, -1)
    diff = ii - jj

    def total(t):
        return t.sum(dim=(-2, -1))

    contrast = total(glcm * diff ** 2)
    dissimilarity = total(glcm * diff.abs())
    homogeneity = total(glcm / (1.0 + diff ** 2))
    asm = total(glcm ** 2)
    energy = asm.sqrt()
    mu_i = total(ii * glcm)[..., None, None]
    mu_j = total(jj * glcm)[..., None, None]
    var_i = total((ii - mu_i) ** 2 * glcm)
    var_j = total((jj - mu_j) ** 2 * glcm)
    denom = (var_i * var_j).sqrt()
    corr = torch.where(
        denom < 1e-15, torch.ones_like(denom),
        total(glcm * (ii - mu_i) * (jj - mu_j)) / denom.clamp_min(1e-15))
    g = glcm + 1e-8
    entropy = -total(g * torch.log2(g))
    return torch.stack([contrast, dissimilarity, homogeneity, energy, corr,
                        asm, entropy, var_i], dim=-1)


def glcm_feature_vector(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W) float images -> (B, 8 offsets x 8) features, offset-major,
    on the images' device."""
    q = quantize_reference(images.float())
    feats = [glcm_properties(glcm_single(q, r, c))
             for r, c in reference_offsets()]
    return torch.cat(feats, dim=-1)
