"""Region-overlap metrics (the JAX package's ``metrics/region.py``), on the
masks' device.

Reference: ``Metrics/Region_based_metrics.py``: dice_coefficient:3,
iou_score:18, precision:33, recall:48. This family's precision and recall
divide by |pred| and |true| (``:43-46``), unlike the confusion-matrix
module's TP + FP and TP + FN; both are kept. ``per_class_dice`` scores
integer label maps, all classes in one pass (the trainer's eval step).
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _sums(y_true, y_pred):
    yt = torch.as_tensor(y_true).float()
    yp = torch.as_tensor(y_pred).float()
    return torch.sum(yt * yp), torch.sum(yt), torch.sum(yp)


def dice_coefficient(y_true, y_pred) -> torch.Tensor:
    """2|X∩Y| / (|X| + |Y| + 1e-7). Reference ``:3-16``."""
    inter, st, sp = _sums(y_true, y_pred)
    return 2.0 * inter / (st + sp + _EPS)


def iou_score(y_true, y_pred) -> torch.Tensor:
    """|X∩Y| / (|X∪Y| + 1e-7). Reference ``:18-31``."""
    inter, st, sp = _sums(y_true, y_pred)
    return inter / (st + sp - inter + _EPS)


def precision(y_true, y_pred) -> torch.Tensor:
    """TP / (|pred| + 1e-7). Reference ``:33-46``."""
    inter, _, sp = _sums(y_true, y_pred)
    return inter / (sp + _EPS)


def recall(y_true, y_pred) -> torch.Tensor:
    """TP / (|true| + 1e-7). Reference ``:48-61``."""
    inter, st, _ = _sums(y_true, y_pred)
    return inter / (st + _EPS)


def per_class_dice(y_true_labels: torch.Tensor, y_pred_labels: torch.Tensor,
                   num_classes: int) -> torch.Tensor:
    """(num_classes,) float32 Dice per class, 2|T∩P| / (|T| + |P|), over
    the whole batch in one pass of per-class sums."""
    yt = y_true_labels.reshape(-1).long()
    yp = y_pred_labels.reshape(-1).long()
    zeros = torch.zeros(num_classes, dtype=torch.float32, device=yt.device)
    inter = zeros.index_add(0, yt, (yt == yp).float())
    st = zeros.index_add(0, yt, torch.ones_like(yt, dtype=torch.float32))
    sp = zeros.index_add(0, yp, torch.ones_like(yp, dtype=torch.float32))
    return 2.0 * inter / (st + sp + _EPS)
