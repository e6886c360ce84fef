"""Pixel-error metrics (the JAX package's ``metrics/pixel_error.py``), on
the masks' device.

Reference: ``Metrics/PixelError_based_metrics.py``: mean_squared_error:3,
root_mean_squared_error:21. Float-cast masks, plain mean.
"""

from __future__ import annotations

import torch


def mean_squared_error(y_true, y_pred) -> torch.Tensor:
    yt = torch.as_tensor(y_true).float()
    yp = torch.as_tensor(y_pred).float()
    return torch.mean((yt - yp) ** 2)


def root_mean_squared_error(y_true, y_pred) -> torch.Tensor:
    return torch.sqrt(mean_squared_error(y_true, y_pred))
