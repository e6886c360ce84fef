"""The port's SDNet composite train step (``training/sdnet_pipeline``)
against ``jax.grad`` of the JAX package's ``SDNetTrainer.loss_fn``, on the
CPU, at channels (4, 8, 16, 32, 64), 32x32, batch 2.

The labels are the argmax of the model's own clean masks. The CE reads
``log(clip(mask, 1e-7, 1))``, and a mask of a class whose boundaries lie
above a pixel is c[i] - c[i+1] of two cumulative softmax sums that both
round to within a few ulps of 1: at such a pixel the log reads float32
rounding residue, which XLA's associative-scan cumsum and torch's
sequential one leave differently. With random labels that moves the CE by
~4e-4 of itself; at the argmax every labelled mask is at least 1/4.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.training.sdnet_pipeline import (
    SDNetTrainer as JaxSDNetTrainer,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
    kl_divergence,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.sdnet_pipeline import (
    SDNetTrainer,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    sdnet_state_dict_from_jax,
    sdnet_variables_from_state_dict,
)

CHANNELS = (4, 8, 16, 32, 64)
HW, BATCH = 32, 2


@contextlib.contextmanager
def fixed_normal(eps):
    orig = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: eps
    try:
        yield
    finally:
        jax.random.normal = orig


@pytest.fixture(scope="module")
def case():
    """The port trainer (seeded model), its weights in JAX, a batch, eps,
    and JAX's loss, metrics, gradients and updated batch statistics."""
    trainer = SDNetTrainer(img_size=HW, channels=CHANNELS, device="cpu")
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    v = sdnet_variables_from_state_dict(state)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, HW, HW, 1)).astype(np.float32)
    eps = rng.standard_normal((BATCH, 15)).astype(np.float32)
    with torch.no_grad():
        probe = copy.deepcopy(trainer.model).train()
        labels = probe(torch.from_numpy(x).permute(0, 3, 1, 2),
                       eps=torch.from_numpy(eps))["clean_masks"].argmax(1)
    jt = JaxSDNetTrainer(img_size=HW, channels=CHANNELS)

    def loss(params, stats, x, labels, e):
        with fixed_normal(e):
            return jt.loss_fn(params, stats, x, labels, jax.random.PRNGKey(0))

    (jl, (jmetrics, mutated)), grads = jax.jit(
        jax.value_and_grad(loss, has_aux=True))(
        v["params"], v["batch_stats"], jnp.asarray(x),
        jnp.asarray(labels.numpy()), jnp.asarray(eps))
    return {"trainer": trainer, "state": state, "variables": v, "x": x,
            "labels": labels, "eps": eps, "loss": float(jl),
            "metrics": {k: float(t) for k, t in jmetrics.items()},
            "grads": sdnet_state_dict_from_jax({
                "params": jax.tree.map(np.asarray, grads),
                "batch_stats": v["batch_stats"]}),
            "stats": sdnet_state_dict_from_jax({
                "params": v["params"],
                "batch_stats": jax.tree.map(np.asarray,
                                            mutated["batch_stats"])})}


def _loss_and_grads(case):
    trainer = case["trainer"]
    trainer.model.load_state_dict(case["state"])
    trainer.model.zero_grad(set_to_none=True)
    loss, metrics = trainer.loss_fn(torch.from_numpy(case["x"]),
                                    case["labels"],
                                    eps=torch.from_numpy(case["eps"]))
    loss.backward()
    return float(loss.detach()), metrics


def test_loss_and_gradients_match_jax(case):
    """Relative loss within 1e-5, every term within 1e-5 of the loss, and
    the whole gradient at cosine > 0.9999 with its norm within 1e-4."""
    loss, metrics = _loss_and_grads(case)
    assert abs(loss - case["loss"]) / abs(case["loss"]) < 1e-5
    for k, t in metrics.items():
        diff = abs(float(t.detach()) - case["metrics"][k])
        assert diff < 1e-5 * abs(loss), k
    named = dict(case["trainer"].model.named_parameters())
    assert set(named) <= set(case["grads"])
    got = torch.cat([named[n].grad.flatten() for n in named]).double()
    want = torch.cat([case["grads"][n].flatten() for n in named]).double()
    cos = float(got @ want / (got.norm() * want.norm()))
    assert cos > 0.9999, cos
    assert abs(float(got.norm() / want.norm()) - 1) < 1e-4


def test_running_stats_after_one_step_match_jax(case):
    """The train-mode forward updates every BatchNorm's running statistics
    as flax does (the modality encoder's twice), within 1e-5."""
    _loss_and_grads(case)
    sd = case["trainer"].model.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 43  # 34 in the U-Net, 4 in the heads, 5 encoder
    for k in keys:
        torch.testing.assert_close(sd[k], case["stats"][k], rtol=0,
                                   atol=1e-5, msg=k)


def test_three_steps_lower_the_loss():
    """The JAX package's own check (``tests/test_sdnet_fouriernet.py``):
    six anatomical factors, Adam 1e-3, random images and labels."""
    trainer = SDNetTrainer(img_size=HW, n_anatomical_factors=6,
                           channels=CHANNELS, learning_rate=1e-3,
                           device="cpu")
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random((2, HW, HW, 1)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 4, (2, HW, HW)))
    state = trainer.init()
    step = trainer.make_train_step()
    g = torch.Generator().manual_seed(3)
    losses = [float(step(state, x, y, generator=g)[0]) for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 3


def test_kl_divergence_matches_jax():
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training.losses import (
        kl_divergence as jax_kl,
    )

    rng = np.random.default_rng(1)
    m, lv = (rng.standard_normal((4, 15)).astype(np.float32) for _ in "ab")
    np.testing.assert_allclose(
        float(kl_divergence(torch.from_numpy(m), torch.from_numpy(lv))),
        float(jax_kl(jnp.asarray(m), jnp.asarray(lv))), rtol=1e-6)
