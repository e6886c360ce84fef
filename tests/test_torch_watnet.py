"""The port's Haar transform, WAT gate and WAT-Net (``ops/dwt.py``,
``models/watnet.py``) against the JAX package's on the same numpy-seeded
inputs and weights, carried by ``utils/convert.layer_map``: the DWT's
four subbands and the IDWT round trip in both packages; the WAT gate; the
model at 64x64, batch 2, in eval and train mode at 1e-4 scale-relative
with the running statistics after the train call (the decoder calling the
encoder's four WATs again); the train-mode gradient of a WAT shared by
two calls against ``jax.grad``;
the parameter tree at the default width."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    watnet as jwatnet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    dwt as jdwt,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    watnet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    dwt,
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

NC, TOL, HW = 4, 1e-4, 64


def test_dwt_and_round_trip_match_jax():
    """The four subbands equal JAX's (the same float32 operations in the
    same order), and ``haar_idwt2d(haar_dwt2d(x))`` returns x within
    float32 rounding in both packages."""
    x = np.random.default_rng(0).standard_normal((2, 16, 24, 3)).astype(
        np.float32) * 10
    want = jdwt.haar_dwt2d(jnp.asarray(x))
    got = dwt.haar_dwt2d(nchw(x))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().transpose(0, 2, 3, 1),
                                      np.asarray(w))
    back = dwt.haar_idwt2d(*got).numpy().transpose(0, 2, 3, 1)
    jback = np.asarray(jdwt.haar_idwt2d(*want))
    for b in (back, jback):
        np.testing.assert_allclose(b, x, rtol=0, atol=4e-6 * np.abs(x).max())
    np.testing.assert_array_equal(back, jback)


def test_wat_gate_matches_jax():
    """One WAT (DWT in float32, the mean of cA + cH, the two Dense
    layers, the sigmoid gate) at 1e-6."""
    jm = jwatnet.WAT()
    x = normal_images(3, 2, 16).repeat(8, axis=-1) * np.arange(
        1, 9, dtype=np.float32)
    v = jax_variables(jm, x)
    want = jax.jit(jm.apply)(v, x)
    tm = load_jax(watnet.WAT(8, generator=torch.Generator()), v)
    with torch.no_grad():
        assert scale_rel(tm(nchw(x)), want) <= 1e-6


@functools.lru_cache(maxsize=None)
def _jax_case():
    """(input, variables, eval output, train output, batch_stats)."""
    jm = jwatnet.WATNet(num_classes=NC)
    x = normal_images(1, 2, HW)
    v = jax_variables(jm, x)
    return (x, v) + tuple(jax_eval_train(jm, x, v))


def _port():
    return watnet.WATNet(1, NC, generator=torch.Generator())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_watnet_forward(train):
    x, v, want_eval, want_train, stats = _jax_case()
    check_zoo_forward(_port(), v, x, want_train if train else want_eval,
                      stats, train, TOL)


class _JaxSharedGate(fnn.Module):
    """One WAT called on both sides of an ``X2Conv``, as WAT-Net's decoder
    calls the encoder's (JAX's modules)."""

    @fnn.compact
    def __call__(self, x, train=False):
        wat = jwatnet.WAT()
        return wat(jwatnet.X2Conv(8)(wat(x), train))


class _SharedGate(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator()
        self.wat = watnet.WAT(8, generator=g)
        self.conv = watnet.X2Conv(8, 8, generator=g)

    def forward(self, x):
        return self.wat(self.conv(self.wat(x)))


def test_shared_wat_gradient():
    """The family's gradient: a WAT shared by two calls around an
    ``X2Conv`` in train mode, against ``jax.grad``: the WAT's Dense
    layers sum both calls' gradients. WAT-Net's own float32 gradient is
    no reference (the JAX twin's BatchNorm-bias gradients read up to 2e-4
    of their size from the port's at 64x64)."""
    jm = _JaxSharedGate()
    x = normal_images(3, 2, 16).repeat(8, axis=-1) * np.arange(
        1, 9, dtype=np.float32)
    v = jax_variables(jm, x)
    cot = np.random.default_rng(8).standard_normal((2, 16, 16, 8)).astype(
        np.float32)
    *_, grads = jax_eval_train(jm, x, v, cot)
    lmap = ([(f"wat.fc{j + 1}", ("WAT_0", f"Dense_{j}"), "dense")
             for j in (0, 1)]
            + [(f"conv.{n}{j + 1}", ("X2Conv_0", f"{layer}_{j}"), kind)
               for j in (0, 1) for n, layer, kind in (
                   ("conv", "Conv", "conv"), ("bn", "BatchNorm", "bn"))])
    check_zoo_gradient(_SharedGate(), v, x, cot, grads, TOL, lmap)


def test_shared_wats_are_registered_once():
    """Four WATs in one ``ModuleList``: each weight once in the state
    dict, as in the JAX tree (``wats_0`` ... ``wats_3``)."""
    tm = _port()
    assert sum(k.startswith("wats.") for k in tm.state_dict()) == 16
    assert len(list(tm.parameters())) == len(tm.state_dict()) - 3 * sum(
        k.endswith("running_mean") for k in tm.state_dict())


def test_default_width_parameters():
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    default_tree_matches(jax_get_model("watnet"),
                         get_model("watnet", in_channels=1), HW)
