"""The port's RetiFluidNet and its self-dual attention
(``models/retifluidnet.py``) against the JAX package's on the same
numpy-seeded inputs and weights, carried by ``utils/convert.layer_map``:
SDA (float32 pixel and channel attentions, the 1x1 convs, the nearest
resize back) and its gradient against ``jax.grad``; the model at
``base_channels`` 8, 64x64, batch 2, in eval and train mode at 1e-4
scale-relative with the running statistics after the train call (its
40 + 5C channels: the five one-hot "bicon" maps, the main and four
deep-supervision softmaxes, in JAX's order; 10 classes, so that an argmax
of 8 or 9 one-hots to zeros); the parameter tree at the default width."""

import functools

import jax
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    retifluidnet as jreti,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    retifluidnet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from test_torch_common import (
    check_zoo_forward,
    check_zoo_gradient,
    default_tree_matches,
    jax_eval_train,
    jax_variables,
    load_jax,
    nchw,
    normal_images,
    scale_rel,
)

NC, TOL, HW, NB = 10, 1e-4, 64, 8


def _sda_case(hw):
    x = normal_images(3, 2, hw).repeat(8, axis=-1) * np.linspace(
        0.5, 2, 8, dtype=np.float32)
    jm = jreti.SDA()
    return jm, x, jax_variables(jm, x)


@pytest.mark.parametrize("hw", [32, 30], ids=["divisible", "floor"])
def test_sda_matches_jax(hw):
    """SDA at 1e-5 on 8 channels: 8x8 tokens, and at 30x30 (the pool
    floors to 7x7 and the nearest resize stretches it back)."""
    jm, x, v = _sda_case(hw)
    want = jax.jit(jm.apply)(v, x)
    tm = load_jax(retifluidnet.SDA(8), v)
    with torch.no_grad():
        assert scale_rel(tm(nchw(x)), want) <= 1e-5


def test_sda_gradient():
    """The family's gradient: SDA's (both softmaxes, the products, the
    1x1 convs, the pool's and the resize's backward) against
    ``jax.grad``."""
    jm, x, v = _sda_case(32)
    cot = np.random.default_rng(8).standard_normal(x.shape).astype(
        np.float32)

    def loss(params):
        return (jm.apply({"params": params}, x) * cot).sum()

    grads = jax.jit(jax.grad(loss))(v["params"])
    check_zoo_gradient(retifluidnet.SDA(8), v, x, cot, grads, TOL)


@functools.lru_cache(maxsize=None)
def _jax_case():
    jm = jreti.RetiFluidNet(num_classes=NC, base_channels=NB)
    x = normal_images(1, 2, HW)
    v = jax_variables(jm, x)
    return (x, v) + tuple(jax_eval_train(jm, x, v))


def bicon_agrees(got, want, gap=1e-5):
    """The 40 bicon channels of ``got`` (NHWC numpy) equal ``want``'s
    wherever the top two probabilities of the head each map comes from
    (the main softmax, then output1, 2, 3, 4) differ by more than ``gap``
    in ``want``: an argmax at a near-tie may flip. -> the number of
    pixels exempt."""
    n, h, w, c = want.shape
    nc = (c - 40) // 5
    probs = want[..., 40:].reshape(n, h, w, 5, nc)
    # the heads in bicon order: main, output1, output2, output3, output4
    probs = probs[..., [0, 4, 3, 2, 1], :]
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > gap
    g = got[..., :40].reshape(n, h, w, 5, 8)
    wb = want[..., :40].reshape(n, h, w, 5, 8)
    assert set(np.unique(g.sum(-1))) <= {0.0, 1.0}
    np.testing.assert_array_equal(g[clear], wb[clear])
    return int((~clear).sum())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_retifluidnet_forward(train):
    """The 5C probability channels at 1e-4 with the running statistics;
    the bicon maps by ``bicon_agrees`` (at most a few pixels exempt)."""
    x, v, want_eval, want_train, stats = _jax_case()
    want = np.asarray(want_train if train else want_eval)
    tm = retifluidnet.RetiFluidNet(1, NC, NB, generator=torch.Generator())
    full = tm.forward
    seen = []

    def probabilities(t):  # what check_zoo_forward holds to JAX's
        seen.append(full(t))
        return seen[-1][:, 40:]

    tm.forward = probabilities
    check_zoo_forward(tm, v, x, want[..., 40:], stats, train, TOL)
    got = seen[0].numpy().transpose(0, 2, 3, 1)
    assert got.shape == (2, HW, HW, 40 + 5 * NC)
    assert bicon_agrees(got, want) <= 0.001 * 5 * 2 * HW * HW
    np.testing.assert_allclose(got[..., 40:].reshape(2, HW, HW, 5, NC).sum(
        -1), 1.0, rtol=1e-5)


def test_dice_drops_predictions_beyond_the_classes_as_jax():
    """``Trainer``'s validation Dice takes the argmax over RetiFluidNet's
    40 + 5C channels, which can exceed C: JAX's scatter drops such a
    label, and so does the port's ``per_class_dice`` (it raised before)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.metrics.region import (
        per_class_dice as jax_dice,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.metrics.region import (
        per_class_dice,
    )

    rng = np.random.default_rng(4)
    yt = rng.integers(0, NC, (2, 16, 16))
    yp = rng.integers(0, 40 + 5 * NC, (2, 16, 16))
    yp[0, :4] = yt[0, :4]
    got = per_class_dice(torch.from_numpy(yt), torch.from_numpy(yp), NC)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_dice(yt, yp, NC)),
                               rtol=1e-6)


def test_default_width_parameters():
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    default_tree_matches(jax_get_model("retifluidnet"),
                         get_model("retifluidnet"), HW)
