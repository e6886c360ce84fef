"""B-scan preprocessing ahead of the model (NHWC float tensors; the JAX
package's ``ops/preprocess.py``), on the tensor's device.

Stages, each optional, in this order:
1. retina flattening: a per-column surface row (the argmax of the vertical
   gradient of a blurred copy), each column rolled so that its surface
   sits at the median surface row;
2. speckle denoise: a separable [1, 2, 1] / 4 blur;
3. per-image z-score;
4. bilinear resize (``ops/resize.py``) to ``out_hw``.
"""

from __future__ import annotations

import torch

from .padding import replicate_pad_2d
from .resize import resize_bilinear


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


def gaussian_blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """Separable [1, 2, 1] / 4 blur of NHWC images, edge rows and columns
    repeated: rows first, then columns, each ``k0*a + k1*b + k2*c`` in
    JAX's order (the surface is an argmax over the blur, so a changed
    rounding could move it)."""
    k0, k1, k2 = 0.25, 0.5, 0.25
    xv = replicate_pad_2d(x, (0, 0, 1, 1))
    xv = k0 * xv[:, :-2] + k1 * xv[:, 1:-1] + k2 * xv[:, 2:]
    xh = replicate_pad_2d(xv, (1, 1, 0, 0))
    return k0 * xh[:, :, :-2] + k1 * xh[:, :, 1:-1] + k2 * xh[:, :, 2:]


def estimate_surface(x: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 retina surface rows: per column, the argmax (the first
    on ties) of the vertical gradient of the blurred images."""
    g = gaussian_blur_3x3(x)
    grad = g[:, 1:] - g[:, :-1]
    return grad.mean(dim=-1).argmax(dim=1).to(torch.int32)


def _median_row(surface: torch.Tensor) -> torch.Tensor:
    """(B, 1) int32 median of each row of ``surface``, as
    ``jnp.median(...).astype(int32)``: for an even count the mean of the
    middle pair in float32, truncated (``torch.median`` would take the
    lower one)."""
    s = surface.sort(dim=1).values.float()
    w = s.shape[1]
    mid = s[:, (w - 1) // 2: w // 2 + 1].mean(dim=1, keepdim=True)
    return mid.to(torch.int32)


def flatten_retina(x: torch.Tensor, surface: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Roll each column so that its surface row (``surface`` (B, W), by
    default ``estimate_surface(x)``) moves to the median surface row; rows
    wrap around, floor-mod H."""
    B, H, W, C = x.shape
    if surface is None:
        surface = estimate_surface(x)
    surface = torch.as_tensor(surface, device=x.device)
    shift = (surface - _median_row(surface)).long()  # positive: roll up
    rows = torch.arange(H, device=x.device)[None, :, None]
    src = torch.remainder(rows + shift[:, None, :], H)  # (B, H, W)
    return torch.gather(x, 1, src[..., None].expand(B, H, W, C))


def preprocess(x: torch.Tensor, out_hw: tuple[int, int] | None = None, *,
               flatten: bool = False, denoise: bool = False,
               normalize: bool = True) -> torch.Tensor:
    """(N, H, W, C) images -> contiguous float32, through the stages asked
    for (the graphs' kernels take contiguous tensors only)."""
    x = x.float().contiguous()
    if flatten:
        x = flatten_retina(x)
    if denoise:
        x = gaussian_blur_3x3(x)
    if normalize:
        x = zscore(x)
    if out_hw is not None and tuple(out_hw) != tuple(x.shape[1:3]):
        x = resize_bilinear(x, out_hw)
    return x
