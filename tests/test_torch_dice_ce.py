"""K8/K9, the port's fused Dice + CE loss (``ops/dice_ce.py``), on the CPU:
the plain versions inside the autograd function against the JAX package's
``dice_ce_loss_pallas`` (Pallas in interpret mode) and against the port's
unfused ``dice_ce_loss``, at the tolerances of ``tests/test_pallas_loss.py``
(loss rtol 1e-5; gradient rtol 1e-4, atol 1e-8; bf16 logits: loss rtol
2e-2, gradient rtol 0.1, atol 1e-6)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_loss import (
    dice_ce_loss_pallas,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training.losses import (
    dice_ce_loss as jax_dice_ce_loss,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    dice_ce as k89,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
    dice_ce_loss,
)


def _case(shape, nc, seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal(shape + (nc,)) * 3.0).astype(np.float32)
    labels = rng.integers(0, nc, shape[:3]).astype(np.int32)
    return logits, labels


def _port(fn, logits, labels, weights, dw, dtype=torch.float32):
    t = torch.tensor(logits, dtype=dtype, requires_grad=True)
    loss = fn(t, torch.tensor(labels), weights, dw)
    (g,) = torch.autograd.grad(loss, t)
    return float(loss.detach()), g


def _jax(fn, logits, labels, weights, dw, dtype=jnp.float32):
    return jax.value_and_grad(lambda t: fn(t, jnp.asarray(labels), weights,
                                           dw))(jnp.asarray(logits, dtype))


CASES = [(7, None, 1.0), (10, None, 0.5), (7, "weights", 1.0),
         (10, "weights", 0.5)]


@pytest.mark.parametrize("nc,cw,dw", CASES)
def test_fused_loss_and_grad_match_jax_pallas(nc, cw, dw):
    logits, labels = _case((2, 32, 128), nc, seed=0)
    weights = None if cw is None else np.linspace(0.5, 2.0, nc).astype(
        np.float32)
    want, want_g = _jax(dice_ce_loss_pallas, logits, labels,
                        None if weights is None else jnp.asarray(weights), dw)
    got, g = _port(k89.dice_ce_loss_fused, logits, labels, weights, dw)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-8)


@pytest.mark.parametrize("nc,cw,dw", CASES)
def test_fused_loss_and_grad_match_unfused(nc, cw, dw):
    logits, labels = _case((2, 32, 128), nc, seed=1)
    weights = None if cw is None else np.linspace(0.5, 2.0, nc).astype(
        np.float32)
    want, want_g = _port(dice_ce_loss, logits, labels, weights, dw)
    got, g = _port(k89.dice_ce_loss_fused, logits, labels, weights, dw)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), want_g.numpy(), rtol=1e-4,
                               atol=1e-8)


def test_bf16_logits_match_jax_pallas():
    logits, labels = _case((1, 16, 128), 4, seed=5)
    want, want_g = _jax(dice_ce_loss_pallas, logits, labels, None, 1.0,
                        jnp.bfloat16)
    got, g = _port(k89.dice_ce_loss_fused, logits, labels, None, 1.0,
                   torch.bfloat16)
    assert g.dtype == torch.bfloat16
    np.testing.assert_allclose(got, float(want), rtol=2e-2)
    np.testing.assert_allclose(g.float().numpy(),
                               np.asarray(want_g, np.float32), rtol=0.1,
                               atol=1e-6)


def test_width_96_matches_jax():
    """W % 128 != 0: JAX takes its XLA loss there; the port's kernels take
    any width."""
    logits, labels = _case((2, 16, 96), 6, seed=7)
    want, want_g = _jax(dice_ce_loss_pallas, logits, labels, None, 1.0)
    want_xla = _jax(jax_dice_ce_loss, logits, labels, None, 1.0)[0]
    assert float(want) == float(want_xla)
    got, g = _port(k89.dice_ce_loss_fused, logits, labels, None, 1.0)
    np.testing.assert_allclose(got, float(want), rtol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-8)


def test_nchw_entry_matches_nhwc():
    logits, labels = _case((2, 8, 20), 5, seed=3)
    a = k89.dice_ce_loss_fused(torch.tensor(logits), torch.tensor(labels))
    b = k89.dice_ce_loss_fused(torch.tensor(logits).permute(0, 3, 1, 2),
                               torch.tensor(labels), nchw=True)
    np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def test_labels_outside_the_classes_match_jax_pallas():
    """A label outside [0, C) has no one-hot row and no CE weight, in the
    JAX kernel and here."""
    logits, labels = _case((2, 16, 128), 5, seed=9)
    labels[0, :3] = -1
    labels[1, 5:9] = 5
    weights = np.linspace(0.5, 2.0, 5).astype(np.float32)
    want, want_g = _jax(dice_ce_loss_pallas, logits, labels,
                        jnp.asarray(weights), 1.0)
    got, g = _port(k89.dice_ce_loss_fused, logits, labels, weights, 1.0)
    np.testing.assert_allclose(got, float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-8)


def test_stats_reference_counts():
    """The statistics add up: sum p over classes = pixels, counts = the
    label histogram, sum w = pixels under uniform weights."""
    logits, labels = _case((2, 4, 6), 3, seed=11)
    s = k89.dice_ce_stats_reference(torch.tensor(logits),
                                    torch.tensor(labels), torch.ones(3))
    assert s.shape == (11,) and s.dtype == torch.float32
    np.testing.assert_allclose(float(s[3:6].sum()), 48, rtol=1e-6)
    np.testing.assert_array_equal(s[6:9].numpy(),
                                  np.bincount(labels.ravel(), minlength=3))
    assert float(s[10]) == 48 and float(s[9]) < 0


def test_more_than_32_classes_raise_off_the_cpu():
    """The kernels take at most 32 classes; a tensor off the CPU with more
    raises before anything launches (checked here on the meta device)."""
    x = torch.empty((1, 4, 4, 33), device="meta")
    lab = torch.empty((1, 4, 4), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="33 classes"):
        k89.dice_ce_loss_fused(x, lab)
    with pytest.raises(ValueError, match="33 classes"):
        k89.dice_ce_bwd(x, lab, torch.empty(99, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        k89.dice_ce_stats(x[..., :32], lab, torch.empty(32, device="meta"))
