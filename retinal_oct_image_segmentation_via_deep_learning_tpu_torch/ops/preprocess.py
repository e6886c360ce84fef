"""B-scan preprocessing ahead of the served graph (NHWC float tensors).

Only the per-image z-score is ported; retina flattening and speckle
denoise (the JAX package's ``ops/preprocess.py``) raise
``NotImplementedError`` until the data-and-preprocessing slice
(ROADMAP.md, Queue A).
"""

from __future__ import annotations

import torch


def zscore(x: torch.Tensor, dims=(1, 2, 3), eps: float = 1e-7) -> torch.Tensor:
    """Per-image z-score with the population std.

    The statistics are summed in float64 and rounded to x's dtype: a CUDA
    reduction splits its sums differently for different batch sizes, and
    the rounding hides that, so an image gets the same values whichever
    batch it is served in."""
    xd = x.double()
    m = xd.mean(dim=dims, keepdim=True).to(x.dtype)
    s = xd.std(dim=dims, keepdim=True, correction=0).to(x.dtype)
    return (x - m) / (s + eps)


def preprocess(x: torch.Tensor, *, flatten: bool = False,
               denoise: bool = False, normalize: bool = True) -> torch.Tensor:
    """(N, H, W, C) images -> float32, z-scored per image when
    ``normalize``."""
    if flatten or denoise:
        raise NotImplementedError(
            "retina flattening and denoise are not ported yet; see "
            "ROADMAP.md, Queue A"
        )
    x = x.float()
    return zscore(x) if normalize else x
