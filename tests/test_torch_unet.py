"""The port's U-Net and its int8 quantization against the JAX package, on the
same (randomized) weights carried across by ``utils/convert``:

* float forward at 1e-4 scale-relative;
* BN fold bit-equal;
* calibration taps at rtol 1e-5 (float sums in another order);
* ``quantize_unet`` / ``quantize_unet_psrp`` bit-equal given JAX's taps;
* the all-int8 oracle graph: logits bit-equal given JAX's qparams (both
  round the requant twice, in eager float32);
* the served graph on a non-square image, held to the JAX contract.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    psrp as jpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    quantized as jq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    psrp as tpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    quantized as tq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    UNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_qparams_from_jax,
    unet_state_dict_from_jax,
)
from test_torch_common import jax_unet, normal_images

F, NC, HW = 16, 10, 32


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX variables, port model) with identical weights."""
    jm, v = jax_unet(F, NC, HW)
    tm = UNet(1, NC, F)
    tm.load_state_dict(unet_state_dict_from_jax(v))
    return jm, v, tm.eval()


@pytest.fixture(scope="module")
def folded(pair):
    _, v, tm = pair
    return jq.fold_unet_bn(v), tq.fold_unet_bn(tm)


def _hwio(name, w):
    """Port layer weights -> the JAX layout."""
    w = w.numpy()
    return w.transpose(2, 3, 0, 1) if name.startswith("ct") else \
        w.transpose(2, 3, 1, 0)


def test_unet_float_forward(pair):
    jm, v, tm = pair
    x = normal_images(1, 2, HW)
    want = np.asarray(jm.apply(v, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


def test_fold_unet_bn_bit_equal(folded):
    j, t = folded
    assert list(j) == list(t)
    for name in j:
        np.testing.assert_array_equal(_hwio(name, t[name]["w"]), j[name]["w"])
        np.testing.assert_array_equal(t[name]["b"].numpy(), j[name]["b"])


def test_calibrate_unet_taps(folded):
    j, t = folded
    x = normal_images(0, 2, HW)
    want = jq.calibrate_unet(j, [x])
    got = tq.calibrate_unet(t, [x])
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-5), k


def _assert_qparams_equal(tp, jp_, names):
    for name in names:
        np.testing.assert_array_equal(_hwio(name, tp[name]["w_q"]),
                                      np.asarray(jp_[name]["w_q"]), name)
        np.testing.assert_array_equal(tp[name]["s_w"].numpy(),
                                      np.asarray(jp_[name]["s_w"]), name)
        np.testing.assert_array_equal(tp[name]["b"].numpy(),
                                      np.asarray(jp_[name]["b"]), name)
    for k, v in jp_["_act_scales"].items():
        assert tp["_act_scales"][k].dtype == torch.float32
        assert tp["_act_scales"][k].item() == np.float32(v), k


def test_quantize_unet_and_psrp_bit_equal(folded):
    j, t = folded
    taps = jq.calibrate_unet(j, [normal_images(0, 2, HW)])
    _assert_qparams_equal(tq.quantize_unet(t, taps),
                          jq.quantize_unet(j, taps, pallas=False), j)
    tp = tpsrp.quantize_unet_psrp(t, taps, init_features=F)
    _assert_qparams_equal(tp, jpsrp.quantize_unet_psrp(j, taps,
                                                       init_features=F), j)
    tp = tpsrp.quantize_unet_psrp(t, taps, init_features=F, deep_int4=True)
    _assert_qparams_equal(tp, jpsrp.quantize_unet_psrp(
        j, taps, init_features=F, deep_int4=True), j)
    with pytest.raises(ValueError, match="deep_int4"):
        tpsrp.quantize_unet_psrp(t, taps, init_features=F, deep_int4="w2")


def test_unet_int8_forward_bit_equal(folded):
    j, _ = folded
    taps = jq.calibrate_unet(j, [normal_images(0, 2, HW)])
    jqp = jq.quantize_unet(j, taps, pallas=False)
    x = normal_images(1, 2, HW)
    want = np.asarray(jq.unet_int8_forward(jqp, jnp.asarray(x)))
    got = tq.unet_int8_forward(unet_qparams_from_jax(jqp), torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_unet_psrp_forward_nonsquare():
    """H != W through the port's own pipeline against JAX's int8 and float
    graphs (the regime of tests/test_psrp_forward.py's contract): catches an
    H/W transposition in the graph or the plain kernels."""
    H, W, nc = 96, 64, 7
    _, v = jax_unet(16, nc, hw=32, randomize=False)
    rng = np.random.default_rng(0)
    calib = rng.standard_normal((1, H, W, 1)).astype(np.float32)
    x = rng.standard_normal((1, H, W, 1)).astype(np.float32)
    j = jq.fold_unet_bn(v)
    taps = jq.calibrate_unet(j, [calib])
    ref8 = np.asarray(jnp.argmax(jq.unet_int8_forward(
        jq.quantize_unet(j, taps, pallas=False), jnp.asarray(x)), -1))
    ref32 = np.asarray(jnp.argmax(jq.folded_forward(j, jnp.asarray(x)), -1))
    tm = UNet(1, nc, 16)
    tm.load_state_dict(unet_state_dict_from_jax(v))
    t = tq.fold_unet_bn(tm)
    qp = tpsrp.quantize_unet_psrp(t, tq.calibrate_unet(t, [calib]),
                                  init_features=16)
    lab = tpsrp.unet_psrp_forward(qp, torch.from_numpy(x), nc).numpy()
    assert lab.shape == (1, H, W)
    assert (lab == ref8).mean() > 0.995
    assert (lab == ref32).mean() > 0.95
    with pytest.raises(ValueError, match="divisible by 16"):
        tpsrp.unet_psrp_forward(qp, torch.zeros(1, H, W + 8, 1), nc)
