"""Helpers shared by the PyTorch port's tests, and tests of its small modules
(registry, config, preprocessing) against the JAX package.

Inputs come from numpy generators and cross between the two frameworks as
numpy arrays; JAX runs on the CPU (tests/conftest.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.models.unet import (
    UNet as JaxUNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.preprocess import (
    zscore as jax_zscore,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
    DataConfig,
    ModelConfig,
    get_model,
    list_models,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
    preprocess,
    zscore,
)


def randomize_unet_variables(variables, seed=0, gain=2.0):
    """U-Net weights with random BN affines and statistics (the README's
    parity regime), so that a wrong BN fold shows. The 3x3 kernels are
    scaled by ``gain`` from the torch-default init (sqrt(6) would be He
    variance), so activations do not vanish and the labels are not one
    class, while the argmax stays far enough from ties for the int8
    contracts."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            bn = any("BatchNorm" in p for p in path)
            if k == "kernel" and v.ndim == 4 and v.shape[0] == 3:
                v = v * gain
            elif k == "mean":
                v = rng.normal(0, 0.1, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias" and bn:
                v = rng.normal(0, 0.1, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return {"params": walk(variables["params"]),
            "batch_stats": walk(variables["batch_stats"])}


def jax_unet(f, nc=10, hw=64, seed=0, randomize=True):
    """(JAX UNet module, variables as numpy dicts): initialised from
    ``seed``, then randomized by ``randomize_unet_variables`` unless
    ``randomize`` is false."""
    model = JaxUNet(out_channels=nc, init_features=f)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 1)))
    if randomize:
        return model, randomize_unet_variables(v, seed)
    return model, jax.tree.map(np.asarray, v)


def jax_relaynet(f, nc=4, hw=64, seed=0, randomize=True):
    """(JAX ReLayNet module, variables as numpy dicts): initialised from
    ``seed``; unless ``randomize`` is false, with random BN affines and
    statistics, conv biases and PReLU slopes, so that a wrong fold or a
    slope taken from the wrong block shows."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.models.relaynet import (
        ReLayNet,
    )

    model = ReLayNet(num_classes=nc, num_filters=f)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 1)),
                   train=False)
    rng = np.random.default_rng(seed)
    draw = {"mean": lambda s: rng.normal(0, 0.1, s),
            "var": lambda s: rng.uniform(0.5, 1.5, s),
            "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0, 0.1, s),
            "alpha": lambda s: rng.uniform(0.05, 0.5, s)}

    def walk(tree):
        # keeps the dicts' call order, which the JAX package's
        # import_torch_state zips against (jax.tree.map would sort keys)
        return {k: walk(t) if isinstance(t, dict) else np.asarray(
                    draw[k](t.shape) if randomize and k in draw else t,
                    np.float32)
                for k, t in tree.items()}

    return model, {"params": walk(v["params"]),
                   "batch_stats": walk(v["batch_stats"])}


def rand_int8(rng, shape, lo=-100, hi=100):
    return rng.integers(lo, hi, shape).astype(np.int8)


def normal_images(seed, n, hw):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 1)
    ).astype(np.float32)


def agreement(a, b):
    return float((np.asarray(a, np.int64) == np.asarray(b, np.int64)).mean())


def psrp_reference_case(f, nc=10, hw=64, deep_int4=False):
    """The JAX side of the whole-graph comparisons, computed once per module.

    * ``qparams``/``psrp``: PSRP qparams of the randomized U-Net (in the
      ``deep_int4`` mode) and the labels of the JAX PSRP graph (Pallas in
      interpret mode on the CPU).
    * ``variables``/``int8``/``float``: the regime of the JAX graph's own
      contract test (tests/test_psrp_forward.py): the U-Net as initialised,
      and the labels of the all-int8 and float graphs. Under the randomized
      weights the argmax sits so close to ties that even the JAX PSRP graph
      misses its own 0.995 contract against the int8 graph (98.2% at f=32),
      and a 1e-5 change of a calibrated scale moves ~4% of the labels.
    """
    from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
        psrp as jpsrp,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
        quantized as jq,
    )

    x = normal_images(1, 2, hw)
    xj = jnp.asarray(x)
    calib = [normal_images(0, 2, hw)]
    _, vr = jax_unet(f, nc, hw)
    layers = jq.fold_unet_bn(vr)
    qp = jax.tree.map(jnp.asarray, jpsrp.quantize_unet_psrp(
        layers, jq.calibrate_unet(layers, calib), init_features=f,
        deep_int4=deep_int4))
    _, v = jax_unet(f, nc, hw, randomize=False)
    layers = jq.fold_unet_bn(v)
    q8 = jq.quantize_unet(layers, jq.calibrate_unet(layers, calib),
                          pallas=False)
    return {
        "f": f, "nc": nc, "x": x, "qparams": qp, "variables": v,
        "deep_int4": deep_int4,
        "psrp": np.asarray(jpsrp.unet_psrp_forward(qp, xj, nc, tg=4)),
        "int8": np.asarray(jnp.argmax(jq.unet_int8_forward(q8, xj), -1)),
        "float": np.asarray(jnp.argmax(jq.folded_forward(layers, xj), -1)),
    }


def port_psrp_labels_given_jax_qparams(case, **kw):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        attach_kernel_params,
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_qparams_from_jax,
    )

    qp = attach_kernel_params(unet_qparams_from_jax(case["qparams"]))
    return unet_psrp_forward(qp, torch.from_numpy(case["x"]), case["nc"],
                             **kw)


def port_psrp_labels_full_pipeline(case):
    """The port's own fold, calibration and quantization of the same
    weights, then its served graph."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        quantize_unet_psrp,
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
        UNet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_state_dict_from_jax,
    )

    model = UNet(1, case["nc"], case["f"])
    model.load_state_dict(unet_state_dict_from_jax(case["variables"]))
    layers = tq.fold_unet_bn(model)
    taps = tq.calibrate_unet(layers, [normal_images(0, 2, case["x"].shape[1])])
    qp = quantize_unet_psrp(layers, taps, init_features=case["f"],
                            deep_int4=case["deep_int4"])
    return unet_psrp_forward(qp, torch.from_numpy(case["x"]), case["nc"])


def test_registry():
    assert list_models() == ["relaynet", "sdnet", "unet"]
    m = get_model("unet", num_classes=4, init_features=4)
    assert m.conv.out_channels == 4
    m = get_model("relaynet", num_classes=4, num_filters=8)
    assert m.classifier.out_channels == 4
    assert m.encode1.conv.kernel_size == (7, 3)
    m = get_model("sdnet", num_classes=5, img_size=32, channels=(4, 8))
    assert m.layer_predictor.head.out_channels == 4
    assert m.surface_predictor.head.out_channels == 12 - 5
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_model("fouriernet")


def test_config_defaults_match_jax():
    from retinal_oct_image_segmentation_via_deep_learning_tpu import config

    for ours, theirs in ((ModelConfig(), config.ModelConfig()),
                         (DataConfig(), config.DataConfig())):
        for field, value in vars(ours).items():
            assert getattr(theirs, field) == value, field


def test_zscore_matches_jax():
    x = np.random.default_rng(0).uniform(0, 255, (2, 16, 24, 1))
    x = x.astype(np.float32)
    want = np.asarray(jax_zscore(jnp.asarray(x)))
    got = zscore(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(preprocess(torch.from_numpy(x)).numpy(),
                                  got)
    # flattening is ported: JAX's pipeline within 1e-5
    from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.preprocess import (
        preprocess as jax_preprocess,
    )

    np.testing.assert_allclose(
        preprocess(torch.from_numpy(x), flatten=True).numpy(),
        np.asarray(jax_preprocess(jnp.asarray(x), flatten=True)),
        rtol=1e-5, atol=1e-5)
