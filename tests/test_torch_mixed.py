"""The port's mixed int8 graph (``inference/quantized.quantize_unet_mixed``
/ ``unet_mixed_forward``) against the JAX package's, on the CPU.

Weights: the port's seeded U-Net (f=8, 10 classes), carried to JAX by
``utils/convert.unet_variables_from_state_dict``; the taps of the port's
calibration go to both quantizers. JAX runs eagerly, as its graph runs
off the TPU.

* ``deep="xla"``: the deep convs on ``_qconv`` (two float32 roundings),
  JAX's graph with its own default backend. ``shallow="int8"``: the
  float32 logits bit for bit. ``shallow="bf16"``: within 2^-7 of the
  largest logit (one bf16 ulp of a logit in [1, 2)), labels 0.99:
  XLA's and torch's bf16 CPU convs accumulate in float32 in other orders
  and round once to bf16, so a logit may differ by a rounding of a conv
  upstream (the reading at these seeds: 0 at 32x32; 0.0078 at f=8, 64x64,
  largest logit 3.39).
* ``deep="pallas"`` (JAX's name): the deep convs on K1's wrapper, whose plain version
  runs on a CPU tensor (one rounding: ``fmaf(acc, scale, bias)``),
  against JAX forced onto its Pallas branch inside the test
  (``jax.default_backend`` patched to "tpu", ``pallas_conv_int8.
  conv3x3_int8`` to its jitted pure-XLA ``conv3x3_int8_reference``, which
  contracts the requant into an FMA too): ``shallow="int8"`` bit for bit,
  ``"bf16"`` as above.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    quantized as jq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    pallas_conv_int8 as jpc,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    quantized as tq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    build_unet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.conv_int8 import (
    unpack_conv3x3_mma_weights,
    unpack_conv3x3_weights,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_variables_from_state_dict,
)

from test_torch_common import normal_images

F, NC, HW = 8, 10, 32
BF16_TOL = 2.0 ** -7


@pytest.fixture(scope="module")
def case():
    tm = build_unet(1, NC, init_features=F, seed=3)
    v = unet_variables_from_state_dict(tm.state_dict())
    j, t = jq.fold_unet_bn(v), tq.fold_unet_bn(tm)
    taps = tq.calibrate_unet(t, [normal_images(0, 2, HW)])
    return {"j": j, "t": t, "jqp": jq.quantize_unet_mixed(j, taps),
            "tqp": tq.quantize_unet_mixed(t, taps),
            "x": normal_images(1, 2, HW)}


def _pallas_branch(monkeypatch):
    ref = jax.jit(jpc.conv3x3_int8_reference,
                  static_argnames=("by", "relu", "out_int8", "out_clip",
                                   "pad_vals"))

    def conv3x3_int8(x, w_packed, scale, bias, *, th=None, **kw):
        del th  # the Pallas grid's strip height
        return ref(x, w_packed, scale, bias, **kw)

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpc, "conv3x3_int8", conv3x3_int8)


def _hwio(name, w):
    w = w.float().numpy()
    return w.transpose(2, 3, 0, 1) if name.startswith("ct") else \
        w.transpose(2, 3, 1, 0)


def test_quantize_unet_mixed_matches_jax(case):
    j, jqp, tqp = case["j"], case["jqp"], case["tqp"]
    for name in j:
        np.testing.assert_array_equal(_hwio(name, tqp[name]["w_q"]),
                                      jqp[name]["w_q"], name)
        np.testing.assert_array_equal(tqp[name]["s_w"].numpy(),
                                      jqp[name]["s_w"], name)
        np.testing.assert_array_equal(
            _hwio(name, tqp[name]["w_bf16"]),
            np.asarray(jqp[name]["w_bf16"], np.float32), name)
        np.testing.assert_array_equal(tqp[name]["b_f32"].numpy(),
                                      jqp[name]["b_f32"], name)
        assert ("w_k" in tqp[name]) == (name in tq.DEEP_STAGES), name
    for name in tq.DEEP_STAGES:
        w_q = tqp[name]["w_q"]
        cout, cin = w_q.shape[:2]
        assert torch.equal(unpack_conv3x3_weights(tqp[name]["w_k"], cin,
                                                  cout), w_q)
        assert torch.equal(unpack_conv3x3_mma_weights(tqp[name]["w_m"], cin,
                                                      cout), w_q)
    for k, s in jqp["_act_scales"].items():
        assert tqp["_act_scales"][k].item() == np.float32(s), k


@pytest.fixture(scope="module")
def jax_logits(case):
    """JAX's mixed graph on both routes and in both shallow modes."""
    x = jnp.asarray(case["x"])
    out = {}
    for shallow in ("int8", "bf16"):
        out["xla", shallow] = np.asarray(jq.unet_mixed_forward(
            case["jqp"], x, shallow=shallow, deep="xla"), np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _pallas_branch(mp)
        for shallow in ("int8", "bf16"):
            out["pallas", shallow] = np.asarray(jq.unet_mixed_forward(
                case["jqp"], x, shallow=shallow), np.float32)
    return out


@pytest.mark.parametrize("deep", ["xla", "pallas"])
@pytest.mark.parametrize("shallow", ["int8", "bf16"])
def test_unet_mixed_forward_matches_jax(case, jax_logits, deep, shallow):
    got = tq.unet_mixed_forward(case["tqp"], torch.from_numpy(case["x"]),
                                shallow=shallow, deep=deep)
    assert got.dtype == (torch.float32 if shallow == "int8"
                         else torch.bfloat16)
    got = got.float().numpy()
    want = jax_logits[deep, shallow]
    assert got.shape == (2, HW, HW, NC)
    if shallow == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= BF16_TOL * np.abs(want).max()
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("deep,calls", [("pallas", 10), ("xla", 0)])
def test_unet_mixed_forward_calls_k1_ten_times(case, monkeypatch, deep,
                                               calls):
    """The kernel route takes K1 (its wrapper; the plain version on the
    CPU) for exactly the ten deep 3x3 convs, two of them with the fused
    pool."""
    seen = []

    def counted(inputs, *args, **kw):
        seen.append(kw.get("pool", False))
        return real(inputs, *args, **kw)

    real = tq.conv3x3_int8
    monkeypatch.setattr(tq, "conv3x3_int8", counted)
    tq.unet_mixed_forward(case["tqp"], torch.from_numpy(case["x"]),
                          shallow="int8", deep=deep)
    assert len(seen) == calls
    assert sum(seen) == (2 if calls else 0)


def test_unet_mixed_forward_rejects_unknown_modes(case):
    x = torch.from_numpy(case["x"])
    with pytest.raises(ValueError, match="shallow"):
        tq.unet_mixed_forward(case["tqp"], x, shallow="fp8")
    with pytest.raises(ValueError, match="deep"):
        tq.unet_mixed_forward(case["tqp"], x, deep="cudnn")
