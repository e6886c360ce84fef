"""Surface-distance metrics over binary masks, on the device (the device
half of the JAX package's ``metrics/contour.py``).

Boundaries are the mask's boundary pixel centres: foreground pixels with a
background 4-neighbour or on the image edge. Each mask keeps its first
``max_points`` boundary pixels in raster order, as JAX's ``lax.top_k`` over
the 0/1 indicator does (it is stable); a cumulative count selects them
here, because ``torch.topk`` is not stable. Values differ from the
reference's marching-squares contours by up to ~0.7 px (JAX's documented
approximation). The host marching-squares path (``find_contours``,
``surface_distances``) is not ported yet (ROADMAP.md, Queue A item 9).

The batched helpers take (M, H, W) masks and are what
``metrics/volume.volume_boundary_metrics`` runs; the public functions take
one (H, W) mask pair, as JAX's do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def boundary_coords(masks: torch.Tensor, max_points: int):
    """(M, H, W) masks (> 0.5 is foreground) -> ((M, max_points, 2) float32
    (row, col) boundary coordinates, inf where there is no point; (M,)
    counts). The count is the number of boundary pixels, not clipped to
    ``max_points`` unless the image has fewer pixels than that (as JAX)."""
    m = masks > 0.5
    M, H, W = m.shape
    mp = F.pad(m.float(), (1, 1, 1, 1))
    neigh_min = torch.minimum(
        torch.minimum(mp[:, :-2, 1:-1], mp[:, 2:, 1:-1]),
        torch.minimum(mp[:, 1:-1, :-2], mp[:, 1:-1, 2:]))
    flat = (m & (neigh_min < 0.5)).reshape(M, H * W)
    count = flat.sum(dim=1)
    k = min(max_points, H * W)
    if k < max_points:
        count = count.clamp_max(k)
    rank = flat.cumsum(dim=1) - 1
    which, idx = torch.nonzero(flat & (rank < k), as_tuple=True)
    coords = torch.full((M, max_points, 2), float("inf"),
                        device=masks.device)
    slot = rank[which, idx]
    coords[which, slot, 0] = (idx // W).float()
    coords[which, slot, 1] = (idx % W).float()
    return coords, count


def surface_distances_batched(y_true: torch.Tensor, y_pred: torch.Tensor,
                              max_points: int):
    """(M, H, W) mask pairs -> (d1 (M, K) pred->true, d2 (M, K) true->pred,
    n_pred (M,), n_true (M,)); padded entries are NaN."""
    ct, n_t = boundary_coords(y_true, max_points)
    cp, n_p = boundary_coords(y_pred, max_points)
    valid_t, valid_p = torch.isfinite(ct[..., 0]), torch.isfinite(cp[..., 0])
    ct0, cp0 = ct.nan_to_num(posinf=0.0), cp.nan_to_num(posinf=0.0)
    dy = cp0[:, :, None, 0] - ct0[:, None, :, 0]  # (M, Kp, Kt)
    dx = cp0[:, :, None, 1] - ct0[:, None, :, 1]
    dist = (dy * dy + dx * dx).sqrt()
    del dy, dx
    inf = torch.tensor(float("inf"), device=dist.device)
    nan = torch.tensor(float("nan"), device=dist.device)
    d1 = torch.where(valid_t[:, None, :], dist, inf).amin(dim=2)
    d1 = torch.where(valid_p, d1, nan)
    d2 = torch.where(valid_p[:, :, None], dist, inf).amin(dim=1)
    d2 = torch.where(valid_t, d2, nan)
    return d1, d2, n_p, n_t


def surface_distances_device(y_true, y_pred, max_points: int = 2048):
    """(d1, d2, n_pred, n_true) of one (H, W) mask pair: the directed
    minimum distances (NaN-padded to ``max_points``) and the counts."""
    d1, d2, n_p, n_t = surface_distances_batched(
        torch.as_tensor(y_true)[None], torch.as_tensor(y_pred)[None],
        max_points)
    return d1[0], d2[0], n_p[0], n_t[0]


def hausdorff_distance_device(y_true, y_pred, max_points: int = 2048):
    d1, d2, _, _ = surface_distances_device(y_true, y_pred, max_points)
    return torch.maximum(_nanmax(d1), _nanmax(d2))


def assd_device(y_true, y_pred, max_points: int = 2048):
    d1, d2, _, _ = surface_distances_device(y_true, y_pred, max_points)
    return (d1.nanmean() + d2.nanmean()) / 2.0


def mad(y_true, y_pred):
    """Mean absolute mask difference (plain |a-b| mean, as the reference's
    ``mad``)."""
    yt = torch.as_tensor(y_true).float()
    yp = torch.as_tensor(y_pred).float()
    return (yt - yp).abs().mean()


def _nanmax(d: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmax``: NaN only where every element is NaN."""
    return torch.where(d.isnan(), float("-inf"), d).amax().where(
        ~d.isnan().all(), float("nan"))
