"""Confusion-matrix metrics of binary masks (the JAX package's
``metrics/confusion.py``), on the masks' device.

Reference: ``Metrics/ConfusionMatrix_based_metrics.py``: accuracy:4,
sensitivity:20, precision:35, specificity:50, auc_score:65. The same
elementwise mask-product formulas with eps = 1e-7 denominators. The counts
are float32 sums, as JAX's: exact up to 2**24 pixels. ``auc_score`` is
``sklearn.roc_auc_score`` (the tie-aware trapezoidal ROC area) with the
reference's 0.0 when only one class is present (``:78-82``).
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _f32(y) -> torch.Tensor:
    return torch.as_tensor(y).float()


def confusion_counts(y_true, y_pred):
    """(TP, TN, FP, FN) as float32 sums over the full arrays."""
    yt, yp = _f32(y_true), _f32(y_pred)
    tp = torch.sum(yt * yp)
    tn = torch.sum((1.0 - yt) * (1.0 - yp))
    fp = torch.sum((1.0 - yt) * yp)
    fn = torch.sum(yt * (1.0 - yp))
    return tp, tn, fp, fn


def accuracy(y_true, y_pred) -> torch.Tensor:
    """(TP + TN) / total (no eps, as the reference ``:4-18``)."""
    tp, tn, _, _ = confusion_counts(y_true, y_pred)
    return (tp + tn) / float(torch.as_tensor(y_true).numel())


def sensitivity(y_true, y_pred) -> torch.Tensor:
    """TP / (TP + FN + 1e-7). Reference ``:20-33``."""
    tp, _, _, fn = confusion_counts(y_true, y_pred)
    return tp / (tp + fn + _EPS)


def precision(y_true, y_pred) -> torch.Tensor:
    """TP / (TP + FP + 1e-7). Reference ``:35-48``."""
    tp, _, fp, _ = confusion_counts(y_true, y_pred)
    return tp / (tp + fp + _EPS)


def specificity(y_true, y_pred) -> torch.Tensor:
    """TN / (TN + FP + 1e-7). Reference ``:50-63``."""
    _, tn, fp, _ = confusion_counts(y_true, y_pred)
    return tn / (tn + fp + _EPS)


def auc_score(y_true, y_score) -> torch.Tensor:
    """ROC AUC, ``sklearn.roc_auc_score``'s value, on the device.

    Pair counting: AUC * P * N = #{score_pos > score_neg} + #{ties} / 2.
    The scores are sorted descending with a stable sort (JAX's argsort is
    stable, so equal scores keep their order); each tie group's positives
    above it and within it come from the cumulative count at its first and
    last element. Single-class input returns 0.0 (the reference's
    ValueError fallback)."""
    yt = _f32(y_true).reshape(-1)
    ys = _f32(y_score).reshape(-1)
    n = yt.shape[0]
    order = torch.argsort(-ys, stable=True)
    yt_s, ys_s = yt[order], ys[order]
    ctp = torch.cumsum(yt_s, dim=0)  # positives with score >= this, inclusive
    ctp_prev = ctp - yt_s  # exclusive
    new_group = torch.ones(n, dtype=torch.long, device=yt.device)
    new_group[1:] = (ys_s[1:] != ys_s[:-1]).long()
    gid = torch.cumsum(new_group, dim=0) - 1
    g_start = torch.zeros(n, device=yt.device).scatter_reduce(
        0, gid, ctp_prev, "amin", include_self=False)
    g_end = torch.zeros(n, device=yt.device).scatter_reduce(
        0, gid, ctp, "amax", include_self=False)
    above = g_start[gid]
    tied = g_end[gid] - above
    pair_sum = torch.sum((1.0 - yt_s) * (above + 0.5 * tied))
    n_pos = torch.sum(yt)
    n_neg = n - n_pos
    auc = pair_sum / torch.clamp_min(n_pos * n_neg, 1.0)
    return torch.where((n_pos == 0) | (n_neg == 0), 0.0, auc)
