"""Padding of NHWC tensors (the JAX package's ``ops/padding.py``).

``pad`` is an int or (left, right, top, bottom), torch's W-first order.
The reflect and replicate pads gather rows and columns by the indices
``np.pad`` gives ``arange`` (the semantics of ``jnp.pad``, a pad wider
than the image included), so they are exact for any dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sides(pad):
    return (pad,) * 4 if isinstance(pad, int) else tuple(pad)


def _gather_pad(x: torch.Tensor, pad, mode: str) -> torch.Tensor:
    l, r, t, b = _sides(pad)
    for dim, lo, hi in ((1, t, b), (2, l, r)):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[dim]), (lo, hi), mode=mode)
            x = x.index_select(dim, torch.from_numpy(idx).to(x.device))
    return x


def reflect_pad_2d(x: torch.Tensor, pad) -> torch.Tensor:
    """torch ``ReflectionPad2d`` on NHWC (the edge row is not repeated)."""
    return _gather_pad(x, pad, "reflect")


def zero_pad_2d(x: torch.Tensor, pad) -> torch.Tensor:
    l, r, t, b = _sides(pad)
    return F.pad(x, (0, 0, l, r, t, b))


def replicate_pad_2d(x: torch.Tensor, pad) -> torch.Tensor:
    """torch ``ReplicationPad2d`` on NHWC (the edge row repeated)."""
    return _gather_pad(x, pad, "edge")
