"""The port's ReLayNet and its int8 quantization against the JAX package, on
the same randomized weights (BN terms, conv biases, PReLU slopes) carried
across by ``utils/convert`` (f=8, 4 classes, 64x64):

* float forward at 1e-4 scale-relative;
* BN fold bit-equal, slopes included;
* calibration taps at rtol 1e-5 (float sums in another order);
* ``quantize_relaynet`` bit-equal given JAX's taps (skip halves folded);
* the all-int8 oracle: logits bit-equal to JAX's eager graph given JAX's
  qparams (both round each operation of the requant on its own);
* the state-dict converters round-trip, both ways.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    relaynet_int8 as jr,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.utils.torch_compat import (
    import_torch_state,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    relaynet_int8 as tr,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.relaynet import (
    ReLayNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    relaynet_qparams_from_jax,
    relaynet_state_dict_from_jax,
    relaynet_variables_from_state_dict,
)
from test_torch_common import jax_relaynet, normal_images

F, NC, HW = 8, 4, 64


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX variables, port model) with identical weights."""
    jm, v = jax_relaynet(F, NC, HW)
    tm = ReLayNet(1, NC, F)
    tm.load_state_dict(relaynet_state_dict_from_jax(v))
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def folded(pair):
    _, v, tm = pair
    return jr.fold_relaynet_bn(v), tr.fold_relaynet_bn(tm)


def _hwio(w):
    return w.numpy().transpose(2, 3, 1, 0)


def test_relaynet_float_forward(pair):
    jm, v, tm = pair
    x = normal_images(1, 2, HW)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_fold_relaynet_bn_bit_equal(folded):
    j, t = folded
    assert sorted(j) == sorted(t)
    for name in j:
        np.testing.assert_array_equal(_hwio(t[name]["w"]), j[name]["w"])
        np.testing.assert_array_equal(t[name]["b"].numpy(), j[name]["b"])
        if name != "head":
            assert t[name]["alpha"].shape == ()
            assert t[name]["alpha"].item() == j[name]["alpha"]


def test_calibrate_relaynet_taps(folded):
    j, t = folded
    x = normal_images(0, 2, HW)
    want = jr.calibrate_relaynet(j, [x])
    got = tr.calibrate_relaynet(t, [x])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def test_quantize_relaynet_bit_equal(folded):
    j, t = folded
    taps = jr.calibrate_relaynet(j, [normal_images(0, 2, HW)])
    want, got = jr.quantize_relaynet(j, taps), tr.quantize_relaynet(t, taps)
    for name in [f"b{i}" for i in range(7)] + ["head"]:
        np.testing.assert_array_equal(_hwio(got[name]["w_q"]),
                                      want[name]["w_q"], name)
        np.testing.assert_array_equal(got[name]["s_w"].numpy(),
                                      want[name]["s_w"], name)
        np.testing.assert_array_equal(got[name]["b"].numpy(),
                                      want[name]["b"], name)
    assert set(got["_act_scales"]) == set(want["_act_scales"])
    for k, v in want["_act_scales"].items():
        assert got["_act_scales"][k].dtype == torch.float32
        assert got["_act_scales"][k].item() == np.float32(v), k


def test_relaynet_int8_forward_bit_equal(folded):
    j, _ = folded
    taps = jr.calibrate_relaynet(j, [normal_images(0, 2, HW)])
    jqp = jr.quantize_relaynet(j, taps)
    x = normal_images(1, 2, HW)
    want = np.asarray(jr.relaynet_int8_forward(
        jax.tree.map(jnp.asarray, jqp), jnp.asarray(x)))
    got = tr.relaynet_int8_forward(relaynet_qparams_from_jax(jqp),
                                   torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want.argmax(-1))) > 1


def test_state_dict_converters_round_trip(pair):
    """JAX variables -> port state dict -> ``import_torch_state`` (which
    zips in registration order) gives the JAX variables back; the port's
    reverse converter agrees with it leaf for leaf; and reconverting gives
    the state dict back."""
    _, v, tm = pair
    sd = tm.state_dict()
    back = import_torch_state(v, sd)
    mine = relaynet_variables_from_state_dict(sd)
    want = jax.tree_util.tree_leaves_with_path(v)
    for tree in (back, mine):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(got) == len(want)
        for path, leaf in want:
            np.testing.assert_array_equal(np.asarray(got[path]),
                                          np.asarray(leaf), str(path))
    again = relaynet_state_dict_from_jax(mine)
    assert list(again) == list(sd)
    for k, t in sd.items():
        assert torch.equal(again[k], t), k
