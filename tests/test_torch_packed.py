"""The row-packed graph (``infer --quantize packed``) against the JAX
package's ``inference/packed.py`` and its TPU kernels, run in interpret
mode: ``conv3x3_int8_packed``, ``stem_conv3x3_int8_packed`` and
``head_argmax_packed`` (the shapes of tests/test_pallas_packed.py) against
the plain versions of K1 and K3, ``quantize_unet_packed`` bit for bit, and
the whole graph at 64x64, f=32, 10 classes.

Given JAX's qparams the labels agree with JAX's ``unet_packed_forward`` to
>= 0.999 (measured: 1.0), not bit for bit by construction: JAX's CPU graph
runs its deep stages (``_qconv``) and its transposed convs (``ct_dot``)
eagerly, rounding the requant twice, where the port (like the TPU graph's
kernels) fuses it into one FMA. From its own calibration the port meets
the JAX graph's contract (tests/test_pallas_packed.py): > 0.995 against the
all-int8 graph, > 0.95 against float (measured: 1.0 and 0.969, as JAX's
own packed graph).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_int8 import (
    pack_weights,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_packed import (
    conv3x3_int8_packed,
    finish_pool_w,
    head_argmax_packed,
    pack_head_weights as jax_pack_head_weights,
    pack_rows,
    pack_stem_weights,
    stem_conv3x3_int8_packed,
    unpack_rows,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    packed as tp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.conv_int8 import (
    conv3x3_int8,
    pack_conv3x3_weights,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.head_argmax import (
    head_argmax,
    pack_head_weights,
)
from test_torch_common import agreement, jax_unet, normal_images, rand_int8

N, H, W, BY = 2, 32, 64, 4


def _w(rng, cin, cout):
    """(3, 3, cin, cout) int8 JAX weights and the port's K1 packing."""
    w = rand_int8(rng, (3, 3, cin, cout), -20, 20)
    return w, pack_conv3x3_weights(torch.from_numpy(
        w.transpose(3, 2, 0, 1).copy()))


def _scale_bias(rng, cout):
    return (rng.uniform(1e-3, 2e-3, cout).astype(np.float32),
            rng.normal(0, 1, cout).astype(np.float32))


@pytest.mark.parametrize("cins,pool", [((8,), False), ((8, 4), False),
                                       ((8,), True)])
def test_k1_plain_matches_conv3x3_int8_packed(cins, pool):
    """A single input, a folded concat, and the fused pool (row half in the
    kernel, W half by ``finish_pool_w``)."""
    rng = np.random.default_rng(0)
    cout = 16
    xs = [rand_int8(rng, (N, H, W, c)) for c in cins]
    w, wk = _w(rng, sum(cins), cout)
    sc, b = _scale_bias(rng, cout)
    out = conv3x3_int8_packed(
        tuple(pack_rows(jnp.asarray(x), BY) for x in xs),
        jnp.asarray(pack_weights(w, BY)), jnp.asarray(sc), jnp.asarray(b),
        by=BY, cins=cins, pool=pool, interpret=True)
    got = conv3x3_int8(tuple(torch.from_numpy(x) for x in xs), wk,
                       torch.from_numpy(sc), torch.from_numpy(b), pool=pool)
    if pool:
        np.testing.assert_array_equal(got[0].numpy(),
                                      np.asarray(unpack_rows(out[0], BY)))
        np.testing.assert_array_equal(
            got[1].numpy(),
            np.asarray(unpack_rows(finish_pool_w(out[1]), BY)))
    else:
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(unpack_rows(out, BY)))


def test_k1_plain_matches_stem_conv3x3_int8_packed():
    rng = np.random.default_rng(1)
    cout, sby = 16, 16
    x = rand_int8(rng, (N, H, W, 1))
    w, wk = _w(rng, 1, cout)
    sc, b = _scale_bias(rng, cout)
    xp = pack_rows(jnp.asarray(x), sby).reshape(N, H // sby, W, sby)
    want = unpack_rows(stem_conv3x3_int8_packed(
        xp, jnp.asarray(pack_stem_weights(w, sby)), jnp.asarray(sc),
        jnp.asarray(b), BY=sby, by_out=BY, interpret=True), BY)
    got = conv3x3_int8(torch.from_numpy(x), wk, torch.from_numpy(sc),
                       torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k3_plain_matches_head_argmax_packed():
    rng = np.random.default_rng(2)
    cin, nc = 8, 5
    x = rand_int8(rng, (N, H, W, cin))
    x[0, 0] = 0  # all-zero pixels: the logits are the biases, tied below
    wh = rng.normal(0, 1, (1, 1, cin, nc)).astype(np.float32)
    s_w = (np.max(np.abs(wh), axis=(0, 1, 2)) / 127.0).astype(np.float32)
    w_q = np.clip(np.round(wh / s_w), -127, 127).astype(np.int8)
    bias = rng.normal(0, 1, nc).astype(np.float32)
    bias[1] = bias[3] = 4.0
    scale = np.float32(0.01) * s_w
    want = head_argmax_packed(
        pack_rows(jnp.asarray(x), BY),
        jnp.asarray(jax_pack_head_weights(w_q, BY, 32)), scale, bias,
        by=BY, nc=nc, interpret=True)
    got = head_argmax(
        torch.from_numpy(x),
        pack_head_weights(torch.from_numpy(w_q[0, 0].T.copy())[..., None,
                                                               None]),
        torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert bool((got[0, 0] == 1).all())


@pytest.fixture(scope="module")
def case():
    """The JAX side, computed once: the U-Net as initialised (the regime of
    JAX's own contract test), its fold, calibration, packed qparams, and
    the labels of the packed, all-int8 and float graphs (the packed graph's
    kernels in interpret mode, ~36 s)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
        packed as jp,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
        quantized as jq,
    )

    _, v = jax_unet(32, nc=10, hw=64, randomize=False)
    layers = jq.fold_unet_bn(v)
    taps = jq.calibrate_unet(layers, [normal_images(0, 2, 64)])
    qp = jp.quantize_unet_packed(layers, taps)
    x = normal_images(1, 2, 64)
    xj = jnp.asarray(x)
    return {
        "variables": v, "layers": layers, "taps": taps, "qparams": qp,
        "x": x,
        "packed": np.asarray(jp.unet_packed_forward(
            jax.tree.map(jnp.asarray, qp), xj, 10)),
        "int8": np.asarray(jnp.argmax(jq.unet_int8_forward(
            jq.quantize_unet(layers, taps, pallas=False), xj), -1)),
        "float": np.asarray(jnp.argmax(jq.folded_forward(layers, xj), -1)),
    }


def _port_layers(layers):
    """JAX folded layers -> the port's layouts."""
    out = {}
    for name, lw in layers.items():
        perm = (2, 3, 0, 1) if name.startswith("ct") else (3, 2, 0, 1)
        out[name] = {"w": torch.from_numpy(
            np.ascontiguousarray(np.asarray(lw["w"]).transpose(perm))),
            "b": torch.from_numpy(np.asarray(lw["b"]).copy())}
    return out


def test_quantize_unet_packed_bit_equal(case):
    """Given the same folded layers and taps, every int8 weight, weight
    scale, bias and activation scale equals JAX's (the skip-half pre-scale
    of blk7_conv0 and blk8_conv0 included)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_packed_qparams_from_jax,
    )

    got = tp.quantize_unet_packed(_port_layers(case["layers"]), case["taps"])
    want = unet_packed_qparams_from_jax(case["qparams"])
    assert set(got) == set(want)
    for name, lw in want.items():
        for k, v in lw.items():
            assert torch.equal(got[name][k], v), (name, k)
    with pytest.raises(ValueError, match="init_features=32"):
        tp.quantize_unet_packed(_port_layers(case["layers"]), case["taps"],
                                init_features=16)


def test_unet_packed_forward_given_jax_qparams(case):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_packed_qparams_from_jax,
    )

    qp = tp.attach_packed_params(unet_packed_qparams_from_jax(case["qparams"]))
    lab = tp.unet_packed_forward(qp, torch.from_numpy(case["x"]), 10)
    assert lab.dtype == torch.int8 and lab.shape == (2, 64, 64)
    assert agreement(lab, case["packed"]) >= 0.999


def test_unet_packed_forward_full_pipeline(case):
    """The port's own fold, calibration and quantization of the same
    weights meet the JAX graph's contract."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
        UNet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_state_dict_from_jax,
    )

    model = UNet(1, 10, 32)
    model.load_state_dict(unet_state_dict_from_jax(case["variables"]))
    layers = tq.fold_unet_bn(model)
    taps = tq.calibrate_unet(layers, [normal_images(0, 2, 64)])
    qp = tp.quantize_unet_packed(layers, taps)
    x = torch.from_numpy(case["x"])
    lab = tp.unet_packed_forward(qp, x, 10)
    assert torch.equal(lab, tp.unet_packed_forward(qp, x, 10,
                                                   reference=True))
    assert agreement(lab, case["int8"]) > 0.995
    assert agreement(lab, case["float"]) > 0.95
    with pytest.raises(ValueError, match="divisible by 16"):
        tp.unet_packed_forward(qp, x[:, :40], 10)
