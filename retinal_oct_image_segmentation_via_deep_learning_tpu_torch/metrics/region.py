"""Region metrics over integer label maps (the JAX package's
``metrics/region.py``; only ``per_class_dice``, which the trainer's eval
step reads, is ported so far)."""

from __future__ import annotations

import torch

_EPS = 1e-7


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
