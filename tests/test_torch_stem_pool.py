"""K10 (the fused stem) and K11 (the standalone int8 pool) against the JAX
package's TPU kernels ``stem_conv_psrp`` and ``pool2x2_int8``, run in
interpret mode, and the fused stem in the port's served graph.

On the CPU the wrappers run their plain versions; the CUDA kernels are held
to those on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_int8 import (
    pool2x2_int8 as jax_pool2x2_int8,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_psrp import (
    pack_psrp_weights,
    pack_stem2_weights,
    prep_stem_window,
    stem_conv_psrp,
    unpack_psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
    build_model,
    build_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
    unet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_int8 as k12,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    stem_conv_int8 as k10,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
    preprocess,
)
from test_torch_common import rand_int8


@pytest.mark.parametrize("by,nph", [(4, 4), (8, 4)])
def test_k10_plain_matches_stem_conv_psrp(by, nph):
    """The shapes of tests/test_psrp_kernels.py's fused-stem test. The stem
    biases reach 3, so a halo that held the stem of a zero-padded image
    (relu(round(bias0))) instead of conv1's zero padding would show at the
    borders."""
    rng = np.random.default_rng(0)
    c1 = cout = 8
    H, W = 4 * by, 16
    x = rng.normal(0, 1, (2, H, W, 1)).astype(np.float32)
    w0 = rand_int8(rng, (3, 3, 1, c1), -20, 20)
    w1 = rand_int8(rng, (3, 3, c1, cout), -20, 20)
    s_in = np.float32(0.01)
    sc0 = rng.uniform(1e-3, 2e-3, c1).astype(np.float32)
    b0 = rng.uniform(-3, 3, c1).astype(np.float32)
    sc1 = rng.uniform(1e-3, 2e-3, cout).astype(np.float32)
    b1 = rng.uniform(-3, 3, cout).astype(np.float32)
    full, pooled = stem_conv_psrp(
        prep_stem_window(jnp.asarray(x), s_in, by=by, nph=nph),
        tuple(jnp.asarray(m) for m in pack_stem2_weights(w0, by, nph)),
        jnp.asarray(sc0), jnp.asarray(b0),
        tuple(jnp.asarray(m) for m in pack_psrp_weights(w1, by, nph)[0]),
        jnp.asarray(sc1), jnp.asarray(b1), by=by, nph=nph, tg=2, pool=True,
        interpret=True,
    )
    xq = torch.round(torch.from_numpy(x) / torch.tensor(s_in)).clamp(
        -127, 127).to(torch.int8)
    t = torch.from_numpy
    got = k10.stem_conv_int8(
        xq, k12.pack_conv3x3_weights(t(w0.transpose(3, 2, 0, 1).copy())),
        t(sc0), t(b0),
        k12.pack_conv3x3_weights(t(w1.transpose(3, 2, 0, 1).copy())),
        t(sc1), t(b1))
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(unpack_psrp(full, by, nph)))
    np.testing.assert_array_equal(
        got[1].numpy(), np.asarray(unpack_psrp(pooled, by // 2, nph // 2)))
    assert int(got[0].max()) > 0


def test_k11_plain_matches_pool2x2_int8():
    rng = np.random.default_rng(1)
    x = rand_int8(rng, (2, 16, 12, 32), -128, 128)
    want = np.asarray(jax_pool2x2_int8(jnp.asarray(x), interpret=True))
    got = k12.pool2x2_int8(torch.from_numpy(x))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def test_k11_rejects_odd_sizes():
    with pytest.raises(ValueError, match="even"):
        k12.pool2x2_int8(torch.zeros((1, 4, 5, 8), dtype=torch.int8))


def test_unet_psrp_forward_stem_fuse_equals_unfused(monkeypatch):
    """64x64, f=16: the graph with the fused stem gives the labels of the
    graph without it, bit for bit; ``OCTSEG_PSRP_STEM_FUSE`` switches it on
    as in the JAX package, and the plain path (``reference=True``) takes it
    too."""
    model = build_model(num_classes=5, init_features=16, seed=0,
                        device="cpu")
    _, calib = build_psrp_forward(model, image_size=64, device="cpu")
    x = preprocess(torch.tensor(
        np.random.default_rng(2).uniform(0, 255, (2, 64, 64, 1)),
        dtype=torch.float32))
    qp = calib["qparams"]
    want = unet_psrp_forward(qp, x, 5, stem_fuse=False)
    assert torch.equal(unet_psrp_forward(qp, x, 5, stem_fuse=True), want)
    assert torch.equal(
        unet_psrp_forward(qp, x, 5, stem_fuse=True, reference=True), want)
    calls = []
    real = k10.stem_conv_int8_reference
    monkeypatch.setattr(
        "retinal_oct_image_segmentation_via_deep_learning_tpu_torch."
        "inference.psrp.stem_conv_int8",
        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("OCTSEG_PSRP_STEM_FUSE", "1")
    assert torch.equal(unet_psrp_forward(qp, x, 5), want)
    monkeypatch.delenv("OCTSEG_PSRP_STEM_FUSE")
    assert torch.equal(unet_psrp_forward(qp, x, 5), want)
    assert calls == [1]
