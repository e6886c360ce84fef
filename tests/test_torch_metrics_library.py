"""The five metric families of the port (``metrics/confusion.py``,
``region.py``, ``contour.py``'s host path, ``pixel_error.py``,
``biomarker.py``) against the JAX package's on the same seeded masks:
values within 1e-4 (the zoo's metric contract, ``tests/test_metrics.py``),
confusion counts exact, ``find_contours`` equal arrays of the same dtype."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu import metrics as J
from retinal_oct_image_segmentation_via_deep_learning_tpu.metrics import (
    biomarker as jbio,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.metrics import (
    contour as jc,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
    metrics as T,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.metrics import (
    biomarker as tbio,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.metrics import (
    contour as tc,
)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-4)


def _pair(seed, shape=(40, 48), p=0.4):
    """Binary (y_true, y_pred) int32 masks: a box plus speckle each."""
    rng = np.random.default_rng(seed)
    yt = (rng.random(shape) < p).astype(np.int32)
    yp = np.where(rng.random(shape) < 0.2, 1 - yt, yt).astype(np.int32)
    yt[..., 5:30, 10:30] = 1
    yp[..., 7:31, 12:33] = 1
    return yt, yp


CASES = {
    "speckle": _pair(0),
    "batched": _pair(1, (3, 24, 32)),
    "all-zero pred": (_pair(2)[0], np.zeros((40, 48), np.int32)),
    "both empty": (np.zeros((16, 16), np.int32),) * 2,
    "both full": (np.ones((16, 16), np.int32),) * 2,
}

PAIR_METRICS = ["accuracy", "sensitivity", "cm_precision", "specificity",
                "dice_coefficient", "iou_score", "precision", "recall",
                "mean_squared_error", "root_mean_squared_error",
                "thickness_difference", "vascularity_index", "mad"]


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("name", PAIR_METRICS)
def test_pair_metrics_match_jax(name, case):
    yt, yp = CASES[case]
    want = getattr(J, name)(jnp.asarray(yt), jnp.asarray(yp))
    got = getattr(T, name)(torch.from_numpy(yt), torch.from_numpy(yp))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _close(got, want)
    # numpy inputs, as the JAX functions take
    _close(getattr(T, name)(yt, yp), want)


@pytest.mark.parametrize("case", list(CASES))
def test_confusion_counts_are_exact(case):
    yt, yp = CASES[case]
    want = J.confusion_counts(jnp.asarray(yt), jnp.asarray(yp))
    got = T.confusion_counts(torch.from_numpy(yt), torch.from_numpy(yp))
    assert [float(g) for g in got] == [float(w) for w in want]
    assert sum(float(g) for g in got) == yt.size


def test_soft_predictions_match_jax():
    """Probability maps in place of binary predictions (the reference's
    formulas are mask products, so they take them)."""
    rng = np.random.default_rng(3)
    yt = (rng.random((32, 40)) < 0.5).astype(np.float32)
    yp = rng.random((32, 40)).astype(np.float32)
    for name in PAIR_METRICS:
        _close(getattr(T, name)(yt, yp),
               getattr(J, name)(jnp.asarray(yt), jnp.asarray(yp)))


@pytest.mark.parametrize("shape", [(24, 32), (2, 24, 32)])
def test_thickness_map_matches_jax(shape):
    yt, _ = _pair(4, shape)
    got = tbio.thickness_map(torch.from_numpy(yt))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbio.thickness_map(yt)))
    assert got.shape == shape[:-2] + shape[-1:]


# ------------------------------------------------------------------- AUC


def _auc_case(kind, n=2000, seed=5):
    rng = np.random.default_rng(seed)
    labels = (rng.random(n) < 0.3).astype(np.int32)
    scores = rng.random(n).astype(np.float32) + 0.3 * labels
    if kind == "tied":  # 11 distinct scores, shared by both classes
        scores = np.round(scores * 10) / 10
    elif kind == "all tied":
        scores = np.full(n, 0.5, np.float32)
    elif kind == "one positive":
        labels = np.zeros(n, np.int32)
        labels[7] = 1
    elif kind == "2d":
        labels, scores = labels.reshape(40, 50), scores.reshape(40, 50)
    return labels, scores.astype(np.float32)


@pytest.mark.parametrize("kind", ["distinct", "tied", "all tied",
                                  "one positive", "2d"])
def test_auc_matches_jax_and_sklearn(kind):
    labels, scores = _auc_case(kind)
    want = float(J.auc_score(jnp.asarray(labels), jnp.asarray(scores)))
    got = T.auc_score(torch.from_numpy(labels), torch.from_numpy(scores))
    _close(got, want)
    sklearn = pytest.importorskip("sklearn.metrics")
    _close(got, sklearn.roc_auc_score(labels.ravel(), scores.ravel()))


def test_auc_ties_need_the_stable_sort():
    """Tied scores in an order where an unstable sort could put a tie
    group's positives first: the group counts half, whatever the order."""
    labels = np.array([0, 1, 0, 1, 1, 0, 0, 1], np.int32)
    scores = np.array([0.2, 0.2, 0.2, 0.2, 0.9, 0.9, 0.1, 0.1], np.float32)
    want = float(J.auc_score(jnp.asarray(labels), jnp.asarray(scores)))
    _close(T.auc_score(labels, scores), want)
    _close(want, 0.5)


@pytest.mark.parametrize("value", [0, 1])
def test_auc_single_class_is_zero(value):
    labels = np.full(64, value, np.int32)
    scores = np.random.default_rng(6).random(64).astype(np.float32)
    assert float(T.auc_score(labels, scores)) == 0.0
    assert float(J.auc_score(jnp.asarray(labels), jnp.asarray(scores))) == 0.0


# -------------------------------------------------------------- contours


def _blobs(seed, shape=(48, 56)):
    """A smoothed random field thresholded into several blobs (some
    touching the border, some with holes)."""
    rng = np.random.default_rng(seed)
    f = rng.random((shape[0] // 4 + 2, shape[1] // 4 + 2))
    f = np.kron(f, np.ones((4, 4)))[:shape[0], :shape[1]]
    return (f > 0.55).astype(np.int32)


def _saddles():
    m = np.zeros((10, 12), np.int32)
    m[1:4, 1:4] = 1
    m[4:7, 4:7] = 1  # diagonal contact: a case-9 saddle
    m[1:4, 9:11] = 1
    m[4:6, 7:9] = 1  # anti-diagonal contact: a case-6 saddle
    return m


def _duplicate_keys():
    """Values exactly at the level on grid corners: segments of adjacent
    cells meet at one vertex from several sides (duplicate endpoint
    keys, the scalar walk's path)."""
    rng = np.random.default_rng(8)
    return rng.choice([0.0, 0.5, 1.0], (12, 14), p=[0.4, 0.2, 0.4])


CONTOURS = {"blobs": _blobs(0), "blobs2": _blobs(1), "saddles": _saddles(),
            "duplicate keys": _duplicate_keys(),
            "empty": np.zeros((8, 8), np.int32),
            "one pixel": np.pad(np.ones((1, 1)), 3)}


@pytest.mark.parametrize("case", list(CONTOURS))
@pytest.mark.parametrize("level", [0.5, 0.25])
def test_find_contours_equals_jax(case, level):
    arr = CONTOURS[case]
    got = T.find_contours(arr, level)
    want = J.find_contours(arr, level)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_find_contours_takes_both_chain_orderings(monkeypatch):
    """Unique endpoint keys take the pointer-doubling ordering, duplicate
    ones the scalar walk, as JAX's."""
    taken = []
    for name in ("_order_chains_vec", "_order_chains_walk"):
        real = getattr(tc, name)
        monkeypatch.setattr(tc, name, lambda *a, _n=name, _r=real: (
            taken.append(_n), _r(*a))[1])
    T.find_contours(_saddles())
    T.find_contours(_duplicate_keys())
    assert taken == ["_order_chains_vec", "_order_chains_walk"]


def test_saddle_case_holds_both_saddles():
    """The saddle input reaches both saddle rows of the case table (6 and
    9), each emitting two segments."""
    m = _saddles()
    case = ((m[:-1, :-1] > 0.5) + 2 * (m[:-1, 1:] > 0.5)
            + 4 * (m[1:, :-1] > 0.5) + 8 * (m[1:, 1:] > 0.5))
    assert {6, 9} <= set(case.ravel().tolist())
    assert len(tc._cell_segments(m.astype(float), 0.5)) == len(
        jc._cell_segments(m.astype(float), 0.5))


def _region(seed, shape=(64, 72)):
    """One wobbly elliptical region (its contour has ~150 points)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    ang = np.arctan2(yy - 32, xx - 36)
    r = 20 + 3 * np.sin(3 * ang + rng.uniform(0, 6)) + rng.uniform(-2, 2)
    return (np.hypot(yy - 32, xx - 36) < r).astype(np.int32)


DISTANCE_CASES = {"regions": (_region(2), _region(3)),
                  "shifted": (_region(4), np.roll(_region(4), 3, axis=1)),
                  "same": (_region(5), _region(5)),
                  "blobs": (_blobs(2), _blobs(3))}


@pytest.mark.parametrize("case", list(DISTANCE_CASES))
@pytest.mark.parametrize("name", ["hausdorff_distance",
                                  "hausdorff_distance_95", "assd"])
def test_contour_distances_match_jax(case, name):
    yt, yp = DISTANCE_CASES[case]
    want = getattr(J, name)(yt, yp)
    got = getattr(T, name)(torch.from_numpy(yt), torch.from_numpy(yp))
    assert isinstance(got, float)
    _close(got, want)
    _close(getattr(T, name)(yt, yp), want)


@pytest.mark.parametrize("case", list(DISTANCE_CASES))
def test_surface_distances_match_jax(case):
    """Hundreds of points (``torch.cdist``'s matrix-product formula would
    take over above 25): the explicit float32 differences agree with
    JAX's."""
    yt, yp = DISTANCE_CASES[case]
    d1, d2 = T.surface_distances(yt, yp)
    w1, w2 = J.surface_distances(yt, yp)
    assert d1.dtype == np.float32
    assert len(d1) > 25 or case == "blobs"
    np.testing.assert_allclose(d1, w1, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(d2, w2, rtol=1e-6, atol=1e-6)


def test_min_dists_is_jax_s_float32_formula():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 512, (300, 2))
    b = rng.uniform(0, 512, (200, 2))
    got = tc._min_dists(torch.tensor(a, dtype=torch.float32),
                        torch.tensor(b, dtype=torch.float32)).numpy()
    want = np.asarray(jc._min_dists(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_exports_are_jax_s():
    names = [n for n in dir(J) if not n.startswith("_")
             and callable(getattr(J, n))]
    assert names and all(callable(getattr(T, n)) for n in names)
    assert T.cm_precision is T.confusion.precision
    assert T.precision is T.region.precision
