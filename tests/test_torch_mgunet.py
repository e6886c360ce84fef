"""The port's MGU-Net (``models/mgunet.py``: ``mgunet`` and ``mgunet_2``)
against the JAX package's on the same numpy-seeded inputs and weights,
carried by ``utils/convert.layer_map``: MGU-Net at feature_scale 8 on
160x160 (a 5x5 bottleneck: the MGR pools by 2 and 3 floor, by 5 divide),
MGU-Net-2 on 48x48 (6x6: by 2 and 3 divide, by 5 floors), and the bilinear
decoder (``is_deconv=False``), in eval and train mode at 1e-4
scale-relative with the running statistics after the train call; one
train-mode gradient against ``jax.grad``; the parameter trees at the
default width."""

import functools

import jax
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    mgunet as jmgunet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    mgunet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    layer_map,
    variables_from_state_dict,
)
from test_torch_common import (
    check_zoo_forward,
    default_tree_matches,
    jax_eval_train,
    jax_variables,
    load_jax,
    nchw,
    normal_images,
)

NC, TOL = 4, 1e-4
# (name, kwargs, input side)
CASES = [("mgunet", (("feature_scale", 8),), 160),
         ("mgunet_2", (), 48),
         ("mgunet", (("feature_scale", 8), ("is_deconv", False)), 160)]
IDS = ["mgunet-fs8-160", "mgunet_2-48", "mgunet-bilinear-160"]
# the gradient's case: MGU-Net-2 at feature_scale 16 on 160x160, a 20x20
# bottleneck (the MGR pool by 3 floors). At the forward cases the float32
# gradient is not a reference: the pool by 5 leaves 1x1 maps whose
# BatchNorms see two values (x_hat is +-1 to within eps / d^2, and their
# backward is rounding), and at feature_scale 8 some MGR channels are so
# narrow beside their mean that flax's E[x^2] - mean^2 cancels (JAX's
# float32 gradient of a conv bias before such a BatchNorm is far from its
# exact 0).
GRAD_CASE = ("mgunet_2", (("feature_scale", 16),), 160)


def _kw(case):
    name, kw, _ = case
    return dict(kw, uniform_pool=name == "mgunet_2")


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(input, variables, cotangent, eval output, train output,
    batch_stats[, gradient of sum(train output * cot), GRAD_CASE])."""
    jm = jmgunet.MGUNet(num_classes=NC, **_kw(case))
    hw = case[2]
    x = normal_images(1, 2, hw)
    v = jax_variables(jm, x)
    cot = np.random.default_rng(2).standard_normal((2, hw, hw, NC)).astype(
        np.float32)
    out = jax_eval_train(jm, x, v, cot if case == GRAD_CASE else None)
    return (x, v, cot) + tuple(out)


def _port(case):
    return mgunet.MGUNet(1, NC, generator=torch.Generator(), **_kw(case))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_mgunet_forward(case, train):
    x, v, _, want_eval, want_train, stats = _jax_case(case)[:6]
    check_zoo_forward(_port(case), v, x, want_train if train else want_eval,
                      stats, train, TOL)


def test_mgunet_gradient():
    """One train-mode gradient (the BatchNorms' K6 plain version, the
    GloRe softmax, the floor pools' first-maximum backward) against
    ``jax.grad``, tensor by tensor at 1e-4 of the tensor's largest JAX
    entry. The biases of convs whose output meets a train-mode BatchNorm
    before any nonlinearity have a gradient of zero in exact arithmetic
    (the batch mean takes their constant out), so both sides hold
    rounding there: those are held to 1e-4 of the largest gradient
    entry of all."""
    case = GRAD_CASE
    x, v, cot, _, _, _, grads = _jax_case(case)
    tm = load_jax(_port(case), v).train()
    torch.sum(tm(nchw(x)) * nchw(cot)).backward()
    g = {n: p.grad for n, p in tm.named_parameters()}
    got = variables_from_state_dict({**tm.state_dict(), **g},
                                    layer_map(tm))["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(grads))
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    zero = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(want[path])
        err = float(np.abs(leaf - w).max())
        scale = float(np.abs(w).max())
        if scale < 1e-4 * top:
            zero += 1
            assert path[-1].key == "bias", jax.tree_util.keystr(path)
            assert err <= 1e-4 * top, jax.tree_util.keystr(path)
        else:
            assert err <= TOL * scale, (jax.tree_util.keystr(path),
                                        err / scale)
    # at least the 22 Basconv/UnetConv convs, each before its BatchNorm
    assert zero >= 22


@pytest.mark.parametrize("name", ["mgunet", "mgunet_2"])
def test_default_width_parameters(name):
    """The registry's model at the JAX defaults (feature_scale 4, 11
    classes) at 160x160: the layer map's tree equals ``jax.eval_shape`` of
    the JAX model's init, leaf for leaf, and so does the count."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    default_tree_matches(jax_get_model(name), get_model(name), 160)
