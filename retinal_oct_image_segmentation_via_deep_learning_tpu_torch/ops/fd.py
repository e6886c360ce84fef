"""Fourier-descriptor targets of FourierNet (the JAX package's
``ops/fd.py``; reference ``Layers_Segment/FourierNet/
calculateFourierDescriptors.py``), host numpy.

A binary mask becomes per-pixel FD amplitude maps:
1. its contours (cv2 ``findContours``, RETR_TREE / CHAIN_APPROX_NONE,
   where cv2 is installed; else the marching-squares contours of
   ``metrics/contour.find_contours``, rounded to pixels);
2. per contour, the centroid-distance deltas between consecutive points
   and the cumulative arc length (reference ``:21-35``);
3. the first n Fourier amplitudes sqrt(a^2 + b^2) of the delta sequence
   (``:48-57``), as one (n, length) outer product;
4. the contour pixels zeroed and 1-3 repeated until no contour is left,
   the amplitude maps accumulated (``:66-81``).
"""

from __future__ import annotations

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover - cv2 is optional
    cv2 = None


def fourier_coefficients(contour_pts: np.ndarray, n: int) -> np.ndarray:
    """First ``n`` FD amplitudes of one contour, (L, 2) (row, col) points in
    boundary order."""
    pts = contour_pts.astype(np.float64)
    center = pts.mean(axis=0)
    nxt = np.roll(pts, -1, axis=0)
    d1 = np.sqrt(((pts - center) ** 2).sum(1))
    d2 = np.sqrt(((nxt - center) ** 2).sum(1))
    delta = d1 - d2
    seg = np.sqrt(((pts - nxt) ** 2).sum(1))
    arc = np.cumsum(seg)
    L = arc[-1]
    if L == 0:
        return np.zeros((n,))
    k = np.arange(1, n + 1)[:, None]
    phase = 2 * np.pi * k * arc[None, :] / L
    a = (delta[None, :] * np.sin(phase)).sum(1) / (k[:, 0] * np.pi)
    b = -(delta[None, :] * np.cos(phase)).sum(1) / (k[:, 0] * np.pi)
    return np.sqrt(a * a + b * b)


def _find_contours_cv2(mask_u8):
    contours, _ = cv2.findContours(mask_u8, cv2.RETR_TREE,
                                   cv2.CHAIN_APPROX_NONE)
    # cv2 points are (x=col, y=row); the reference swaps them (:27-28)
    return [c[:, 0, ::-1] for c in contours]


def _find_contours_trace(mask_u8):
    from ..metrics.contour import find_contours

    return [np.rint(c).astype(np.int64) for c in find_contours(mask_u8, 0.5)]


def fd_maps(mask: np.ndarray, n: int = 1) -> np.ndarray:
    """Binary (H, W) mask -> (H, W, n) accumulated FD amplitude maps (the
    reference's shrinking-contour script, ``:60-85``)."""
    h, w = mask.shape
    maps = np.zeros((h, w, n))
    shrinked = (mask > 0).astype(np.uint8)
    find = _find_contours_cv2 if cv2 is not None else _find_contours_trace
    while True:
        contours = find(shrinked)
        if not contours:
            break
        layer = np.zeros((h, w, n))
        for pts in contours:
            if len(pts) == 0:
                continue
            amp = fourier_coefficients(pts, n)
            rows, cols = pts[:, 0], pts[:, 1]
            layer[rows, cols, :] = amp
            shrinked[rows, cols] = 0
        maps += layer
    return maps
