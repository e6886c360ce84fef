"""The port's Res2Net-50 backbone, MSNet, M2SNet and LossNet
(``models/res2net.py``, ``models/msnet.py``) against the JAX package's on
the same numpy-seeded inputs and weights, carried by
``utils/convert.layer_map``: at 64x64, batch 2 (layer4's maps 2x2), in
eval and train mode at 1e-4 scale-relative with the running statistics
after the train call (M2SNet's shared ``CNN1`` BatchNorms updated four
times a unit, in JAX's order; train mode on the well-conditioned draws
of ``TRAIN_DRAW``); a stride-2 ``Bottle2neck``'s train-mode gradient
against ``jax.grad``; ``max_pool(3, 2, padding=1)`` with its gradient;
LossNet; the parameter trees at the default width."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    msnet as jmsnet,
    res2net as jres2net,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pooling import (
    max_pool as jax_max_pool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    msnet,
    res2net,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.pooling import (
    max_pool,
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
)

NC, TOL, HW = 4, 1e-4, 64
# Train mode runs on weights whose BatchNorm biases are N(0, 2^2) and whose
# conv biases are 0 (they leave a train-mode output unchanged: the batch
# mean takes them out). Res2Net's 16 blocks of train-mode BatchNorms are
# ill-conditioned in float32 at the default draws (N(0, 0.1^2) biases: a
# downsample BN sees mean^2 / var up to 124, M2SNet's depthwise filters
# near-constant channels), and the JAX twin's float32 one-pass statistics
# are the less exact side: at 64x64 against the port run in float64,
# Res2Net's layer4 reads 1.16e-3 in JAX and 2.77e-4 in the port, M2SNet
# (biases N(0, 1), conv biases 0) 1.69e-4 and 2.97e-5.
TRAIN_DRAW = {"bias_std": 2.0, "conv_bias_std": 0.0}


@functools.lru_cache(maxsize=None)
def _jm(multi_kernel):
    """The JAX model, one object per variant (one compile of
    ``jax_eval_train`` for both draws)."""
    return jmsnet._MSNetBase(num_classes=NC, multi_kernel=multi_kernel)


@functools.lru_cache(maxsize=None)
def _jax_case(multi_kernel, train):
    """(input, variables, eval output, train output, batch_stats), the
    variables drawn by default (eval) or by ``TRAIN_DRAW`` (train)."""
    jm = _jm(multi_kernel)
    x = normal_images(1, 2, HW)
    v = jax_variables(jm, x, **(TRAIN_DRAW if train else {}))
    return (x, v) + tuple(jax_eval_train(jm, x, v))


def _port(multi_kernel):
    return msnet.MSNet(1, NC, multi_kernel, generator=torch.Generator())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("multi_kernel", [False, True],
                         ids=["msnet", "m2snet"])
def test_msnet_forward(multi_kernel, train):
    x, v, want_eval, want_train, stats = _jax_case(multi_kernel, train)
    check_zoo_forward(_port(multi_kernel), v, x,
                      want_train if train else want_eval, stats, train, TOL)


def test_bottle2neck_gradient():
    """The family's gradient: a stride-2 stage ``Bottle2neck`` (planes 32:
    13-channel splits, the last one average-pooled with its padding
    counted, the downsample's floor pool) in train mode against
    ``jax.grad``. The whole model's float32 gradient is no reference: at
    64x64 the JAX twin's M2SNet gradient below the backbone is up to
    4.3e-4 from the port's run in float64, the port's float32 1.1e-6."""
    jm = jres2net.Bottle2neck(32, 2, True)
    x = normal_images(6, 2, 16).repeat(64, axis=-1) * np.random.default_rng(
        7).uniform(0.5, 1.5, 64).astype(np.float32)
    v = jax_variables(jm, x)
    cot = np.random.default_rng(8).standard_normal((2, 8, 8, 128)).astype(
        np.float32)
    *_, grads = jax_eval_train(jm, x, v, cot)
    tm = res2net.Bottle2neck(64, 32, 2, True, generator=torch.Generator())
    check_zoo_gradient(tm, v, x, cot, grads, TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_res2net_features(train):
    """The backbone alone: its five maps (x1 after the padded max-pool,
    layer1-4; layer1's first block a stride-1 stage block, its last split
    taken as it is; layer2-4's first blocks pooling theirs) at 1e-4."""
    jm = jres2net.Res2Net50Features()
    x = normal_images(3, 2, HW)
    v = jax_variables(jm, x, **(TRAIN_DRAW if train else {}))
    want_eval, want_train, stats = jax_eval_train(jm, x, v)
    tm = res2net.Res2Net50Features(1, generator=torch.Generator())
    got = check_zoo_forward(tm, v, x,
                            tuple(want_train if train else want_eval),
                            stats, train, TOL)
    assert [tuple(t.shape[-3:]) for t in got] == [
        (64, 16, 16), (256, 16, 16), (512, 8, 8), (1024, 4, 4),
        (2048, 2, 2)]


def test_max_pool_padded_strided_matches_jax_with_its_gradient():
    """``max_pool(3, 2, padding=1)`` (both ResNet stems, Res2Net's deep
    stem) against JAX's on small integers, so that overlapping windows
    tie: the values, and the gradient to each window's first maximum (XLA's
    select-and-scatter, ``max_pool2d``'s backward); odd sides too."""
    for hw in ((8, 8), (9, 7)):
        x = np.random.default_rng(hw[1]).integers(
            -2, 3, (2, *hw, 3)).astype(np.float32)
        want, vjp = jax.vjp(lambda t: jax_max_pool(t, 3, 2, padding=1),
                            jnp.asarray(x))
        g = np.random.default_rng(9).standard_normal(want.shape).astype(
            np.float32)
        xt = nchw(x).requires_grad_(True)
        got = max_pool(xt, 3, 2, padding=1)
        got.backward(nchw(g))
        np.testing.assert_array_equal(
            got.detach().numpy().transpose(0, 2, 3, 1), np.asarray(want))
        np.testing.assert_array_equal(xt.grad.numpy().transpose(0, 2, 3, 1),
                                      np.asarray(vjp(g)[0]))


@pytest.mark.parametrize("resize", [False, True], ids=["32", "224"])
def test_lossnet_matches_jax(resize):
    """The perceptual loss of two seeded one-channel images (tiled to
    three, normalised, resized to 224x224 or not) at 1e-5 relative; zero
    for an image against itself."""
    x = normal_images(4, 1, 32)
    y = normal_images(5, 1, 32)
    jm = jmsnet.LossNet(resize=resize)
    v = jax_variables(jm, x, y)
    want = float(jax.jit(jm.apply)(v, x, y))
    tm = load_jax(msnet.LossNet(resize, generator=torch.Generator()), v)
    with torch.no_grad():
        got = float(tm(nchw(x), nchw(y)))
        assert float(tm(nchw(x), nchw(x))) == 0.0
    assert abs(got - want) <= 1e-5 * abs(want)


@pytest.mark.parametrize("name", ["msnet", "m2snet"])
def test_default_width_parameters(name):
    """The registry's model at the JAX defaults: the layer map's tree
    equals ``jax.eval_shape`` of the JAX model's init, leaf for leaf, and
    so does the count."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    default_tree_matches(jax_get_model(name), get_model(name, in_channels=1),
                         64)
