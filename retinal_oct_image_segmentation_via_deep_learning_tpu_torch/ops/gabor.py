"""Fixed Gabor and Haar filter banks and their 'same' convolution (the JAX
package's ``ops/gabor.py``; reference ``Masood_2024.py:18-71``).

The banks are built in numpy (float64, then float32) with the reference's
asymmetric grid ``mgrid[-k//2 : k//2 + 1]`` (kernel_size 7 at sigma 1 is
an 8x8 kernel over offsets -4 ... 3). ``conv_same_torch`` applies a bank
to a one-channel map as ``F.conv2d(padding="same")``, which pads an even
kernel total // 2 before and the rest after, as the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

GABOR_ORIENTATIONS = (0, 45, 90, 135, -45, -135)  # degrees (reference :23)
GABOR_FREQUENCIES = (0.1, 0.25, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)
GABOR_SIGMA = 1.0


def gabor_kernel(frequency: float, theta_deg: float,
                 sigma: float = GABOR_SIGMA) -> np.ndarray:
    """The reference's ``_gabor_kernel`` (:40-46), float64."""
    theta = theta_deg / 180.0 * np.pi
    kernel_size = int(2 * np.ceil(2.5 * sigma) + 1)
    y, x = np.mgrid[
        -kernel_size // 2: kernel_size // 2 + 1,
        -kernel_size // 2: kernel_size // 2 + 1,
    ]
    x_t = x * np.cos(theta) + y * np.sin(theta)
    y_t = -x * np.sin(theta) + y * np.cos(theta)
    return np.exp(-0.5 * (x_t ** 2 + y_t ** 2) / sigma ** 2) * np.cos(
        2 * np.pi * frequency * x_t)


def gabor_bank() -> np.ndarray:
    """(k, k, 1, 48) float32, orientation-major (the reference's loop
    order, :31-37)."""
    ks = [gabor_kernel(f, t) for t in GABOR_ORIENTATIONS
          for f in GABOR_FREQUENCIES]
    return np.stack(ks, axis=-1)[:, :, None, :].astype(np.float32)


HAAR_KERNELS = (
    np.array([[1.0, 1.0], [-1.0, -1.0]]),  # horizontal (reference :65)
    np.array([[1.0, -1.0], [1.0, -1.0]]),  # vertical
    np.array([[1.0, -1.0], [-1.0, 1.0]]),  # diagonal
)


def haar_bank() -> np.ndarray:
    """(2, 2, 1, 3) float32."""
    return np.stack(HAAR_KERNELS, axis=-1)[:, :, None, :].astype(np.float32)


def conv_same_torch(x: torch.Tensor, filters: np.ndarray) -> torch.Tensor:
    """The bank ``filters`` (k, k, 1, F) over the one-channel NCHW map
    ``x`` -> (N, F, H, W), stride 1, 'same' padding, in x's dtype."""
    w = torch.from_numpy(np.ascontiguousarray(filters.transpose(3, 2, 0, 1)))
    return F.conv2d(x, w.to(x.device, x.dtype), padding="same")
