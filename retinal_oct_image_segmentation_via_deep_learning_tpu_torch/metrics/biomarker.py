"""Biomarker metrics (the JAX package's ``metrics/biomarker.py``), on the
masks' device.

Reference: ``Metrics/Biomarker_based_metrics.py``: thickness_difference:3,
vascularity_index:23. Thickness is the per-A-scan (per-column) layer pixel
count, ``np.sum(mask, axis=0)`` on an (H, W) mask (reference ``:14-15``);
here dim -2, so batched (..., H, W) masks work unchanged.
"""

from __future__ import annotations

import torch


def thickness_difference(y_true, y_pred) -> torch.Tensor:
    """Mean |column-thickness difference|. Reference ``:3-21``."""
    t_true = thickness_map(y_true)
    t_pred = thickness_map(y_pred)
    return torch.mean(torch.abs(t_true - t_pred))


def vascularity_index(y_true, y_pred) -> torch.Tensor:
    """|positive-fraction difference|. Reference ``:23-38``."""
    yt = torch.as_tensor(y_true).float()
    yp = torch.as_tensor(y_pred).float()
    return torch.abs(torch.sum(yt) / yt.numel() - torch.sum(yp) / yp.numel())


def thickness_map(mask) -> torch.Tensor:
    """Per-column thickness profile (sum over dim -2)."""
    return torch.sum(torch.as_tensor(mask).float(), dim=-2)
