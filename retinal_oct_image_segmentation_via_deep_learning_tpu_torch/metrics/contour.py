"""Contour and surface-distance metrics (the JAX package's
``metrics/contour.py``).

Reference: ``Metrics/Contour_based_metrics.py``: hausdorff_distance:5,
hausdorff_distance_95:24, assd:41, mad:58. The reference takes the first
contour of each mask from ``skimage.measure.find_contours(mask, 0.5)[0]``
(``:15-16``) and the minimum distances with a Python double loop
(``:19-20``).

The host path: ``find_contours`` is a numpy marching-squares with
skimage's semantics (linear edge interpolation at the level, 'low' saddle
connectivity, contours in the scan order of their first segment), on the
host because its output's shape depends on the data; the distances
between the two first contours are one pairwise reduction in float32 on
the masks' device (explicit differences and a square root, as JAX's: a
matrix-product distance such as ``torch.cdist``'s loses digits).

The device path: boundaries are the mask's boundary pixel centres
(foreground pixels with a background 4-neighbour or on the image edge).
Each mask keeps its first ``max_points`` boundary pixels in raster order,
as JAX's ``lax.top_k`` over the 0/1 indicator does (it is stable); a
cumulative count selects them here, because ``torch.topk`` is not stable.
Values differ from the marching-squares contours by up to ~0.7 px (JAX's
documented approximation). The batched helpers take (M, H, W) masks and
are what ``metrics/volume.volume_boundary_metrics`` runs; the public
functions take one (H, W) mask pair, as JAX's do.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Marching squares (skimage.measure.find_contours semantics)
# ---------------------------------------------------------------------------


# Directed-segment lookup: case (bit 1=ul, 2=ur, 4=ll, 8=lr above level) ->
# up to two (start_edge, end_edge) pairs over edges T=0, B=1, L=2, R=3; -1 =
# no segment. Saddles (6, 9) use 'low' connectivity, matching skimage's
# default.
_T, _B, _L, _R, _N = 0, 1, 2, 3, -1
_CASE_TABLE = np.array(
    [
        (_N, _N, _N, _N),  # 0
        (_T, _L, _N, _N),  # 1
        (_R, _T, _N, _N),  # 2
        (_R, _L, _N, _N),  # 3
        (_L, _B, _N, _N),  # 4
        (_T, _B, _N, _N),  # 5
        (_R, _T, _L, _B),  # 6  saddle
        (_R, _B, _N, _N),  # 7
        (_B, _R, _N, _N),  # 8
        (_T, _L, _B, _R),  # 9  saddle
        (_B, _T, _N, _N),  # 10
        (_B, _L, _N, _N),  # 11
        (_L, _R, _N, _N),  # 12
        (_T, _R, _N, _N),  # 13
        (_L, _T, _N, _N),  # 14
        (_N, _N, _N, _N),  # 15
    ],
    dtype=np.int8,
)


def _cell_segments(arr, level):
    """Directed segments ((r,c) float endpoints) in scan order.

    The case map, the edge interpolations and the segment gathers are numpy
    array ops over all cells; only the final tuples are built in Python
    (O(#segments) ~ O(perimeter))."""
    H, W = arr.shape
    if H < 2 or W < 2:
        return []
    ul = arr[:-1, :-1]
    ur = arr[:-1, 1:]
    ll = arr[1:, :-1]
    lr = arr[1:, 1:]
    case = (
        (ul > level).astype(np.int8)
        + 2 * (ur > level)
        + 4 * (ll > level)
        + 8 * (lr > level)
    )
    ncell = (H - 1) * (W - 1)
    sel = _CASE_TABLE[case].reshape(ncell, 2, 2)  # (cell, slot, start/end)
    cell_idx, slot_idx = np.nonzero(sel[:, :, 0] >= 0)  # row-major = scan order
    e_start = sel[cell_idx, slot_idx, 0]
    e_end = sel[cell_idx, slot_idx, 1]

    # Interpolate edge crossings only for the O(perimeter) selected cells.
    r0 = (cell_idx // (W - 1)).astype(np.float64)
    c0 = (cell_idx % (W - 1)).astype(np.float64)
    ulv = ul.reshape(-1)[cell_idx]
    urv = ur.reshape(-1)[cell_idx]
    llv = ll.reshape(-1)[cell_idx]
    lrv = lr.reshape(-1)[cell_idx]
    # Unselected edges may divide by zero (suppressed — np.choose below only
    # reads edges their case actually crosses).
    with np.errstate(divide="ignore", invalid="ignore"):
        rows = [r0, r0 + 1.0,
                r0 + (level - ulv) / (llv - ulv),
                r0 + (level - urv) / (lrv - urv)]       # T, B, L, R
        cols = [c0 + (level - ulv) / (urv - ulv),
                c0 + (level - llv) / (lrv - llv),
                c0, c0 + 1.0]
    sr, sc = np.choose(e_start, rows), np.choose(e_start, cols)
    er, ec = np.choose(e_end, rows), np.choose(e_end, cols)
    return [
        ((sr[i], sc[i]), (er[i], ec[i])) for i in range(len(cell_idx))
    ]


def find_contours(array, level: float = 0.5) -> list[np.ndarray]:
    """Iso-valued contours of a 2D array, skimage-compatible output.

    Returns a list of (N, 2) float arrays of (row, col) coordinates; closed
    loops repeat the first point at the end. Contours are emitted in the scan
    order their first segment is found, so ``find_contours(m, 0.5)[0]``
    selects the same contour as the reference's skimage call
    (``Contour_based_metrics.py:15-16``).
    """
    arr = np.asarray(array, dtype=np.float64)
    segs = _cell_segments(arr, level)
    n = len(segs)
    if n == 0:
        return []
    pts = np.asarray(segs, dtype=np.float64)  # (n, 2 start/end, 2 r/c)
    key_dt = np.dtype([("r", np.float64), ("c", np.float64)])
    start_k = np.ascontiguousarray(pts[:, 0]).view(key_dt).reshape(n)
    end_k = np.ascontiguousarray(pts[:, 1]).view(key_dt).reshape(n)

    def first_match(keys, queries):
        """queries[i] -> smallest j with keys[j] == queries[i], else -1
        (vectorized equivalent of dict.setdefault-then-get: stable sort
        keeps the lowest original index leftmost among equal keys)."""
        order = np.argsort(keys, kind="stable")
        skeys = keys[order]
        pos = np.searchsorted(skeys, queries)
        posc = np.clip(pos, 0, n - 1)
        out = np.where(
            (pos < n) & (skeys[posc] == queries), order[posc], -1
        )
        return out

    succ = first_match(start_k, end_k)  # segment whose start == my end
    pred = first_match(end_k, start_k)  # segment whose end == my start

    unique_keys = (len(np.unique(start_k)) == n
                   and len(np.unique(end_k)) == n)
    if unique_keys:
        # Vectorized chain assembly (pointer doubling): with unique keys
        # succ/pred are mutually consistent (succ[i]=j <=> pred[j]=i), so
        # the scalar walk's `used` guards never fire and chains are exactly
        # the weakly-connected components of the successor graph, found in
        # O(n log n) numpy work.
        groups = _order_chains_vec(succ, pred, n)
    else:
        # duplicate endpoint keys (level crossing exactly through grid
        # corners): the scalar walk's collision semantics
        groups = _order_chains_walk(succ, pred, n)
    return [
        np.concatenate([pts[g, 0], pts[g[-1:], 1]]) for g in groups
    ]


def _order_chains_walk(succ, pred, n):
    """Scalar chain walk (used on endpoint-key ties)."""
    used = np.zeros(n, dtype=bool)
    groups = []
    for i in range(n):
        if used[i]:
            continue
        used[i] = True
        fwd = [i]
        j = succ[i]
        while j >= 0 and not used[j]:
            used[j] = True
            fwd.append(j)
            j = succ[j]
        bwd = []
        j = pred[i]
        while j >= 0 and not used[j]:
            used[j] = True
            bwd.append(j)
            j = pred[j]
        groups.append(np.asarray(bwd[::-1] + fwd))
    return groups


def _order_chains_vec(succ, pred, n):
    """Chain components + in-chain order via pointer doubling.

    Matches the scalar walk exactly when succ/pred are mutual: contours are
    emitted in ascending min-segment-index order (= the walk's scan-order
    discovery), open chains ordered from their true start, loops broken at
    their minimum-index segment (where the walk's outer loop enters them).
    """
    idx = np.arange(n)
    # min-index representative per weakly-connected chain (hooking +
    # path compression: O(log n) rounds)
    rep = idx.copy()
    nxt = np.where(succ >= 0, succ, idx)
    prv = np.where(pred >= 0, pred, idx)
    for _ in range(n + 1):  # fixpoint reached in far fewer rounds (the
        # double compression step spreads minima multiplicatively), but the
        # bound must be safe: an unconverged rep silently splits chains
        new = np.minimum(rep, np.minimum(rep[nxt], rep[prv]))
        new = np.minimum(new, new[new])
        new = np.minimum(new, new[new])
        if np.array_equal(new, rep):
            break
        rep = new

    # loops have no start node (pred >= 0 everywhere): break each at its
    # representative, where the scalar walk's outer loop would enter
    has_start = np.zeros(n, dtype=bool)
    np.logical_or.at(has_start, rep[pred < 0], True)
    loop_break = (idx == rep) & ~has_start[rep]
    pred = np.where(loop_break, -1, pred)

    # depth from chain start via pointer doubling
    depth = np.where(pred >= 0, 1, 0).astype(np.int64)
    ptr = pred.copy()
    while (ptr >= 0).any():
        pi = np.maximum(ptr, 0)
        step = np.where(ptr >= 0, depth[pi], 0)
        nxt_ptr = np.where(ptr >= 0, ptr[pi], -1)
        depth = depth + step
        ptr = nxt_ptr

    order = np.lexsort((depth, rep))
    reps_sorted = rep[order]
    breaks = np.nonzero(np.diff(reps_sorted))[0] + 1
    return np.split(order, breaks)


# ---------------------------------------------------------------------------
# Surface distances (host contours)
# ---------------------------------------------------------------------------


def _min_dists(from_pts: torch.Tensor, to_pts: torch.Tensor) -> torch.Tensor:
    """For each point in ``from_pts``, the min Euclidean distance to
    ``to_pts`` (float32, explicit differences, as JAX's)."""
    diff = from_pts[:, None, :] - to_pts[None, :, :]
    return torch.sqrt(torch.sum(diff ** 2, dim=-1)).amin(dim=1)


def surface_distances(y_true, y_pred, level: float = 0.5):
    """(d1, d2) float32 numpy: per-point min distances pred->true and
    true->pred between the first contours of the two masks (the
    reference's per-point lists, ``Contour_based_metrics.py:19-20``). The
    distances run on the device of ``y_true`` when it is a tensor."""
    device = y_true.device if isinstance(y_true, torch.Tensor) else "cpu"
    ct, cp = (torch.as_tensor(find_contours(_host(m), level)[0],
                              dtype=torch.float32, device=device)
              for m in (y_true, y_pred))
    d1 = _min_dists(cp, ct).cpu().numpy()
    d2 = _min_dists(ct, cp).cpu().numpy()
    return d1, d2


def _host(mask) -> np.ndarray:
    if isinstance(mask, torch.Tensor):
        return mask.detach().cpu().numpy()
    return np.asarray(mask)


def hausdorff_distance(y_true, y_pred) -> float:
    """max(directed max distances). Reference ``:5-22``."""
    d1, d2 = surface_distances(y_true, y_pred)
    return float(max(d1.max(), d2.max()))


def hausdorff_distance_95(y_true, y_pred) -> float:
    """max of the 95th percentiles of the directed distances (numpy's
    percentile). Reference ``:24-39``."""
    d1, d2 = surface_distances(y_true, y_pred)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def assd(y_true, y_pred) -> float:
    """Average symmetric surface distance. Reference ``:41-56``."""
    d1, d2 = surface_distances(y_true, y_pred)
    return float((d1.mean() + d2.mean()) / 2.0)


# ---------------------------------------------------------------------------
# Device boundaries (pixel centres)
# ---------------------------------------------------------------------------


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
