"""Index max-pool and max-unpool for NHWC tensors, and the plain max-pool of
the float models (strided, padded with -inf), the (strided) average pool
and the adaptive average pool on NCHW tensors (the JAX package's
``ops/pooling.py``), in plain PyTorch.

ReLayNet pools with indices and decodes by unpooling to them. The indices
here are window-local: ``idx`` in [0, k*k) is the flat position ``dy*k + dx``
of the window's maximum, the first maximum in that order on ties (as
``jnp.argmax`` and torch's own pooling pick it). They carry the same
information as torch's global flat indices and are what the int8 serving
graph and its kernel (``ops/conv7x3_int8``) emit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/k, W/k, k*k, C)."""
    N, H, W, C = x.shape
    return (x.reshape(N, H // k, k, W // k, k, C).permute(0, 1, 3, 2, 4, 5)
            .reshape(N, H // k, W // k, k * k, C))


def max_pool_argmax(x: torch.Tensor, k: int = 2):
    """Non-overlapping k x k max-pool of an (N, H, W, C) tensor ->
    (pooled, idx): idx int64 in [0, k*k), first maximum on ties."""
    win = _windows(x, k)
    return win.amax(dim=3), win.argmax(dim=3)  # argmax: the first maximum


def max_unpool(x: torch.Tensor, idx: torch.Tensor, k: int = 2) -> torch.Tensor:
    """Inverse of ``max_pool_argmax``: (N, Ho, Wo, C) values and window
    indices -> (N, k*Ho, k*Wo, C) with each value at its index and zeros
    elsewhere."""
    N, Ho, Wo, C = x.shape
    slots = torch.arange(k * k, device=x.device).view(1, 1, 1, k * k, 1)
    win = torch.where(slots == idx.unsqueeze(3).long(), x.unsqueeze(3),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    return (win.reshape(N, Ho, Wo, k, k, C).permute(0, 1, 3, 2, 4, 5)
            .reshape(N, Ho * k, Wo * k, C))


def max_pool(x: torch.Tensor, k: int = 2, stride: int | None = None,
             padding: int = 0) -> torch.Tensor:
    """k x k max-pool of an (N, C, H, W) tensor at ``stride`` (default k)
    after ``padding`` rows and columns of -inf on each side, as the JAX
    package's: where the windows tile the padded map (stride k, H and W
    multiples of k) its reshape-max, whose gradient splits evenly between
    tied maxima (``amax``'s, as ``jnp.max``'s); otherwise the 'VALID'
    windows (trailing rows and columns that no window reaches dropped)
    with the gradient to the first maximum of each window
    (``max_pool2d``'s, as XLA's select-and-scatter), overlapping windows
    included."""
    stride = stride or k
    if padding:
        x = F.pad(x, (padding,) * 4, value=-math.inf)
    N, C, H, W = x.shape
    if stride != k or H % k or W % k:
        return F.max_pool2d(x, k, stride)
    return x.reshape(N, C, H // k, k, W // k, k).amax(dim=(3, 5))


def avg_pool(x: torch.Tensor, k: int = 2,
             stride: int | None = None) -> torch.Tensor:
    """k x k average pool of an (N, C, H, W) tensor at ``stride`` (default
    k; 'VALID': trailing rows and columns that no window reaches dropped),
    summed in float32 and returned in the input's dtype."""
    return F.avg_pool2d(x.float(), k, stride or k).to(x.dtype)


def adaptive_avg_pool(x: torch.Tensor, out_hw=(1, 1)) -> torch.Tensor:
    """torch ``AdaptiveAvgPool2d`` of an (N, C, H, W) tensor, in float32
    and returned in the input's dtype."""
    return F.adaptive_avg_pool2d(x.float(), out_hw).to(x.dtype)
