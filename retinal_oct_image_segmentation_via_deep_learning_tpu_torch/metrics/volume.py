"""Metrics over a (B, H, W) label volume, on the device (the JAX package's
``metrics/volume.py``): the confusion matrix and the region metrics derived
from it, thickness maps, MSE, and the per-slice contour and biomarker
metrics.

The confusion counts are int64 and exact at any volume size; the JAX
package adds them in float32, which stops being exact above 2**24 pixels
in one cell (64 B-scans of 512x512).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .contour import surface_distances_batched

_EPS = 1e-7
# distance matrices per batch of volume_boundary_metrics: at max_points=1024
# each is 4 MiB (float32), so 64 of them 256 MiB
_MATRICES_PER_BATCH = 64


def volume_confusion(y_true, y_pred, num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64 confusion counts over the volume;
    rows are the true class, columns the predicted one. Pairs outside the
    classes are dropped."""
    yt = torch.as_tensor(y_true).reshape(-1).long()
    yp = torch.as_tensor(y_pred).reshape(-1).long().to(yt.device)
    ok = (yt >= 0) & (yt < num_classes) & (yp >= 0) & (yp < num_classes)
    idx = (yt * num_classes + yp)[ok]
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes)


def metrics_from_confusion(cm: torch.Tensor) -> dict:
    """Per-class Dice, IoU, sensitivity, specificity, precision, accuracy
    and the pixel accuracy from int64 confusion counts, in float64."""
    cm = cm.double()
    total = cm.sum()
    tp = cm.diag()
    fp = cm.sum(dim=0) - tp
    fn = cm.sum(dim=1) - tp
    tn = total - tp - fp - fn
    return {
        "dice": 2 * tp / (2 * tp + fp + fn + _EPS),
        "iou": tp / (tp + fp + fn + _EPS),
        "sensitivity": tp / (tp + fn + _EPS),
        "specificity": tn / (tn + fp + _EPS),
        "precision": tp / (tp + fp + _EPS),
        "accuracy_per_class": (tp + tn) / total.clamp_min(1.0),
        "pixel_accuracy": tp.sum() / total.clamp_min(1.0),
    }


def volume_metrics(y_true, y_pred, num_classes: int) -> dict:
    """Per-class and mean metrics from one confusion pass."""
    cm = volume_confusion(y_true, y_pred, num_classes)
    out = {"confusion": cm, **metrics_from_confusion(cm)}
    out["mean_dice"] = out["dice"].mean()
    out["mean_iou"] = out["iou"].mean()
    return out


def volume_thickness_maps(labels, _unused=None,
                          num_classes: int = 2) -> torch.Tensor:
    """(B, W, num_classes) float32 per-class thickness of each A-scan (the
    column sums of the one-hot labels)."""
    lab = torch.as_tensor(labels).long()
    return F.one_hot(lab, num_classes).float().sum(dim=1)


def volume_mse(y_true, y_pred) -> torch.Tensor:
    yt = torch.as_tensor(y_true).float()
    yp = torch.as_tensor(y_pred).float().to(yt.device)
    return ((yt - yp) ** 2).mean()


def volume_boundary_metrics(y_true, y_pred, num_classes: int,
                            max_points: int = 1024) -> dict:
    """Per-slice, per-class contour and biomarker metrics of a (B, H, W)
    volume, each a (B, num_classes) tensor: ``hd95`` and ``assd`` (boundary
    pixel centres, ``metrics.contour``; NaN where not ``valid``),
    ``thickness_diff`` (mean |column-sum difference| over the A-scans),
    ``vi_diff`` (|difference of the mask fractions|) and ``valid`` (the
    class is present in both the true and the predicted slice)."""
    yt = torch.as_tensor(y_true)
    yp = torch.as_tensor(y_pred).to(yt.device)
    B, H, W = yt.shape
    cls = torch.arange(num_classes, device=yt.device)[None, :, None, None]
    mt = (yt[:, None] == cls).float().reshape(-1, H, W)  # (B*nc, H, W)
    mp = (yp[:, None] == cls).float().reshape(-1, H, W)
    hd95, assd, n_p, n_t = [], [], [], []
    for i in range(0, mt.shape[0], _MATRICES_PER_BATCH):
        d1, d2, p, t = surface_distances_batched(
            mt[i:i + _MATRICES_PER_BATCH], mp[i:i + _MATRICES_PER_BATCH],
            max_points)
        q = torch.tensor(0.95, device=d1.device)
        hd95.append(torch.maximum(
            torch.nanquantile(d1, q, dim=1, interpolation="linear"),
            torch.nanquantile(d2, q, dim=1, interpolation="linear")))
        assd.append((d1.nanmean(dim=1) + d2.nanmean(dim=1)) / 2.0)
        n_p.append(p)
        n_t.append(t)
    valid = ((torch.cat(n_p) > 0) & (torch.cat(n_t) > 0)).reshape(
        B, num_classes)
    nan = torch.tensor(float("nan"), device=yt.device)
    mt, mp = mt.reshape(B, num_classes, H, W), mp.reshape(B, num_classes, H, W)
    return {
        "hd95": torch.where(valid, torch.cat(hd95).reshape(B, -1), nan),
        "assd": torch.where(valid, torch.cat(assd).reshape(B, -1), nan),
        "thickness_diff": (mt.sum(dim=2) - mp.sum(dim=2)).abs().mean(dim=2),
        "vi_diff": (mt.mean(dim=(2, 3)) - mp.mean(dim=(2, 3))).abs(),
        "valid": valid,
    }
