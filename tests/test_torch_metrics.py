"""The device metric suite (``metrics/volume.py``, the device half of
``metrics/contour.py``) and ``Trainer.evaluate`` against the JAX package on
the same seeded masks, within 1e-4.

The masks hold a class absent from some slices (its distance metrics are
masked out), a class present only in the predictions, and a speckled class
with more boundary pixels than ``max_points`` (JAX keeps the first ones in
raster order; so must the port).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.metrics import (
    contour as jc,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.metrics import (
    volume as jv,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.metrics import (
    contour as tc,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.metrics import (
    volume as tv,
)

NC, MAX_POINTS = 5, 64


def _masks(seed, b=3, h=32, w=40):
    """(labels, preds) int32 (b, h, w): class 0 background, 1 a speckle
    (hundreds of boundary pixels), 2 a band, 3 a box in some slices, 4 in
    the predictions of slice 0 only."""
    rng = np.random.default_rng(seed)
    yt = np.zeros((b, h, w), np.int32)
    yt[rng.random((b, h, w)) < 0.3] = 1
    for i in range(b):
        top = rng.integers(4, 12)
        yt[i, top:top + rng.integers(4, 9), :] = 2
        if i != 1:
            y0, x0 = rng.integers(14, 22), rng.integers(2, 30)
            yt[i, y0:y0 + 6, x0:x0 + 8] = 3
    yp = yt.copy()
    flip = rng.random((b, h, w)) < 0.08
    yp[flip] = rng.integers(0, 4, int(flip.sum()))
    yp[0, 28:31, 3:9] = 4
    return yt, yp


def _close(got, want, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=1e-4,
                               atol=1e-4, equal_nan=True, err_msg=what)


def test_boundary_selection_is_raster_order():
    """More boundary pixels than max_points: the first ones in raster
    order, the count unclipped, as JAX's stable top_k."""
    yt, _ = _masks(0)
    m = (yt[0] == 1).astype(np.float32)
    want, want_n = jc._boundary_coords(jnp.asarray(m), MAX_POINTS)
    got, got_n = tc.boundary_coords(torch.from_numpy(m)[None], MAX_POINTS)
    assert int(want_n) == int(got_n[0]) > MAX_POINTS
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("cls", [1, 2, 3, 4])
def test_contour_device_functions_match_jax(cls):
    yt, yp = _masks(1)
    mt = (yt[0] == cls).astype(np.float32)
    mp = (yp[0] == cls).astype(np.float32)
    want = jc.surface_distances_device(jnp.asarray(mt), jnp.asarray(mp),
                                       MAX_POINTS)
    got = tc.surface_distances_device(torch.from_numpy(mt),
                                      torch.from_numpy(mp), MAX_POINTS)
    for g, w_, what in zip(got, want, ("d1", "d2", "n_pred", "n_true")):
        _close(g, w_, what)
    for name in ("hausdorff_distance_device", "assd_device"):
        _close(getattr(tc, name)(torch.from_numpy(mt), torch.from_numpy(mp),
                                 MAX_POINTS),
               getattr(jc, name)(jnp.asarray(mt), jnp.asarray(mp),
                                 MAX_POINTS), name)
    _close(tc.mad(torch.from_numpy(mt), torch.from_numpy(mp)),
           jc.mad(jnp.asarray(mt), jnp.asarray(mp)))


def test_volume_metrics_match_jax():
    yt, yp = _masks(2)
    t, p = torch.from_numpy(yt), torch.from_numpy(yp)
    cm = tv.volume_confusion(t, p, NC)
    assert cm.dtype == torch.int64 and int(cm.sum()) == yt.size
    np.testing.assert_array_equal(
        cm.numpy(), np.asarray(jv.volume_confusion(yt, yp, NC)))
    got, want = tv.volume_metrics(t, p, NC), jv.volume_metrics(yt, yp, NC)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    _close(tv.volume_thickness_maps(t, None, NC),
           jv.volume_thickness_maps(jnp.asarray(yt), None, NC))
    _close(tv.volume_mse(t, p), jv.volume_mse(yt, yp))


def test_volume_boundary_metrics_match_jax():
    yt, yp = _masks(3)
    got = tv.volume_boundary_metrics(torch.from_numpy(yt),
                                     torch.from_numpy(yp), NC, MAX_POINTS)
    want = jv.volume_boundary_metrics(jnp.asarray(yt), jnp.asarray(yp), NC,
                                      MAX_POINTS)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    valid = got["valid"].numpy()
    assert not valid[:, 4].any() and not valid[1, 3] and valid[0, 1]


def test_trainer_evaluate_matches_jax():
    """Both trainers' ``evaluate`` over the same two batches of labels,
    with a ``predict_fn`` that returns the same predictions."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu import (
        config as jcfg,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training.trainer import (
        Trainer as JaxTrainer,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        Trainer,
    )

    batches = [_masks(4), _masks(5)]
    images = [np.full(yt.shape + (1,), float(i), np.float32)
              for i, (yt, _) in enumerate(batches)]
    ds = SimpleNamespace(epoch=lambda e: iter(
        [(images[i], batches[i][0]) for i in range(2)]))

    def preds_of(imgs):
        return batches[int(np.asarray(imgs).flat[0])][1]

    model = {"name": "unet", "num_classes": NC,
             "kwargs": {"init_features": 4}}
    jt = JaxTrainer(jcfg.TrainConfig(model=jcfg.ModelConfig(**model)))
    want = jt.evaluate(None, ds, max_points=MAX_POINTS,
                       predict_fn=lambda s, x: jnp.asarray(preds_of(x)))
    tt = Trainer(TrainConfig(model=ModelConfig(**model)), "cpu")
    got = tt.evaluate(None, ds, max_points=MAX_POINTS,
                      predict_fn=lambda s, x: torch.from_numpy(preds_of(x)))
    assert set(got) == set(want)
    assert got["confusion"].dtype == np.int64
    for k in want:
        _close(got[k], want[k], k)
    got = tt.evaluate(None, ds, contour_metrics=False,
                      predict_fn=lambda s, x: torch.from_numpy(preds_of(x)))
    assert "hd95" not in got and got["pixel_accuracy"] == pytest.approx(
        want["pixel_accuracy"], abs=1e-6)
