"""Quantized artifacts (``inference/artifacts.py``): the port's own round
trip, JAX-written artifacts read by the port, a port int8 artifact read by
the JAX package, and the mode check the JAX CLI lacks (``cli.py:233``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    artifacts as ja,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    packed as jp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    psrp as jpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    quantized as jq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    artifacts as ta,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    packed as tp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    psrp as tpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    quantized as tq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_qparams_from_jax,
)
from test_torch_common import jax_unet, normal_images

HW, NC = 64, 6
# mode -> (JAX quantizer, port attach, port graph)
MODES = {
    "int8": (lambda layers, taps, f: jq.quantize_unet(layers, taps),
             lambda q: q,
             lambda q, x: tq.unet_int8_forward(q, x).argmax(-1)),
    "psrp": (lambda layers, taps, f: jpsrp.quantize_unet_psrp(
                 layers, taps, init_features=f),
             tpsrp.attach_kernel_params,
             lambda q, x: tpsrp.unet_psrp_forward(q, x, NC)),
    "packed": (lambda layers, taps, f: jp.quantize_unet_packed(layers, taps),
               tp.attach_packed_params,
               lambda q, x: tp.unet_packed_forward(q, x, NC)),
}


def _jax_qparams(mode):
    f = 32 if mode == "packed" else 16
    _, v = jax_unet(f, nc=NC, hw=HW)
    layers = jq.fold_unet_bn(v)
    taps = jq.calibrate_unet(layers, [normal_images(0, 2, HW)])
    return MODES[mode][0](layers, taps, f)


def _labels(mode, raw):
    _, attach, graph = MODES[mode]
    return graph(attach(raw), torch.from_numpy(normal_images(1, 2, HW)))


@pytest.mark.parametrize("mode", ["int8", "psrp", "packed"])
def test_port_round_trip(tmp_path, mode):
    """save -> load gives back every w_q, s_w, b and activation scale, and
    the graph's labels; served qparams save as their raw part."""
    raw = unet_qparams_from_jax(_jax_qparams(mode))
    path = str(tmp_path / f"{mode}.npz")
    ta.save_qparams(path, MODES[mode][1](raw), mode)
    back = ta.load_qparams(path, mode)
    assert set(back) == set(raw)
    for name, lw in raw.items():
        for k, v in lw.items():
            assert torch.equal(back[name][k], v), (name, k)
    assert torch.equal(_labels(mode, back), _labels(mode, raw))


@pytest.mark.parametrize("mode", ["psrp", "packed"])
def test_jax_artifact_loads_into_the_port(tmp_path, mode):
    """An artifact the JAX package wrote (TPU packs and all) gives the
    labels of the same qparams handed over in memory."""
    qp = _jax_qparams(mode)
    path = str(tmp_path / f"jax_{mode}.npz")
    ja.save_qparams(path, qp)
    loaded = ta.load_qparams(path, mode)
    assert torch.equal(_labels(mode, loaded),
                       _labels(mode, unet_qparams_from_jax(qp)))


def test_port_int8_artifact_serves_in_jax(tmp_path):
    """The port writes the JAX layout: its int8 artifact is one the JAX
    package's int8 graph serves, with JAX's own logits."""
    qp = _jax_qparams("int8")
    path = str(tmp_path / "port_int8.npz")
    ta.save_qparams(path, unet_qparams_from_jax(qp), "int8")
    x = jnp.asarray(normal_images(1, 2, HW))
    np.testing.assert_array_equal(
        np.asarray(jq.unet_int8_forward(ja.load_qparams(path), x)),
        np.asarray(jq.unet_int8_forward(qp, x)))


def test_mode_mismatch_raises(tmp_path):
    qp = _jax_qparams("psrp")
    path = str(tmp_path / "jax_psrp.npz")
    ja.save_qparams(path, qp)
    with pytest.raises(ValueError, match="a psrp artifact, but --quantize "
                                         "packed"):
        ta.load_qparams(path, "packed")
    ja.save_qparams(path, {**qp, "_deep_int4": True})
    with pytest.raises(ValueError, match="int4 artifact.*item 6"):
        ta.load_qparams(path, "psrp")
    ta.save_qparams(path, unet_qparams_from_jax(qp), "psrp")
    with pytest.raises(ValueError, match="a psrp artifact, but --quantize "
                                         "int8"):
        ta.load_qparams(path, "int8")
    with pytest.raises(ValueError, match="mode 'int4'"):
        ta.save_qparams(path, unet_qparams_from_jax(qp), "int4")
