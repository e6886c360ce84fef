"""K1 (3x3 conv) and K2 (2x2/2 transposed conv) of the PyTorch port: their
plain versions, which CPU tensors take, against the JAX package's Pallas
kernels in interpret mode and its jitted lax reference. All bit-identical:
both sides compute the requant as one FMA (XLA contracts ``acc*s + b``
under jit and in interpret mode; the port emulates the FMA in float64).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    pallas_conv_int8 as jk,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    pallas_conv_psrp as jp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.conv_int8 import (
    conv3x3_int8,
    ct2x2_int8,
    pack_conv3x3_weights,
    pack_ct2x2_weights,
    unpack_conv3x3_weights,
)
from test_torch_common import rand_int8

RNG = np.random.default_rng(0)


def _scales(cout):
    scale = RNG.uniform(1e-3, 2e-3, cout).astype(np.float32)
    bias = RNG.uniform(-3, 3, cout).astype(np.float32)
    return scale, bias


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_conv(xs, w_hwio, scale, bias, **kw):
    w = pack_conv3x3_weights(_t(w_hwio.transpose(3, 2, 0, 1)))
    return conv3x3_int8(tuple(_t(x) for x in xs), w, _t(scale), _t(bias),
                        **kw)


def test_pack_conv3x3_roundtrip():
    for cin, cout in ((1, 8), (5, 3), (40, 70)):
        w = _t(rand_int8(RNG, (cout, cin, 3, 3)))
        wp = pack_conv3x3_weights(w)
        assert wp.shape[0] == 9 and wp.shape[2] % 32 == 0
        assert torch.equal(unpack_conv3x3_weights(wp, cin, cout), w)


@pytest.mark.parametrize("cin,cout,relu", [
    (1, 8, True),    # the stem's Cin=1
    (3, 5, True),    # Cin, Cout not multiples of 4
    (8, 16, True),
    (36, 8, False),  # several 32-channel chunks, no relu
])
def test_k1_single_input(cin, cout, relu):
    x = rand_int8(RNG, (2, 8, 8, cin))
    w = rand_int8(RNG, (3, 3, cin, cout), -20, 20)
    scale, bias = _scales(cout)
    got = _port_conv([x], w, scale, bias, relu=relu).numpy()
    wp = jnp.asarray(jk.pack_weights(w, 1))
    ref = jax.jit(jk.conv3x3_int8_reference, static_argnames=("relu",))(
        jnp.asarray(x), wp, jnp.asarray(scale), jnp.asarray(bias),
        relu=relu,
    )
    np.testing.assert_array_equal(got, np.asarray(ref))
    kern = jk.conv3x3_int8(jnp.asarray(x), wp, jnp.asarray(scale),
                           jnp.asarray(bias), relu=relu, th=8,
                           interpret=True)
    np.testing.assert_array_equal(got, np.asarray(kern))


@pytest.mark.parametrize("by,nph,cins,cout", [
    (2, 2, (8, 8), 8),   # 256^2 family: cat + pool to plain NHWC
    (4, 4, (8,), 8),     # 512^2 family: pool to (by=2, nph=2)
])
def test_k1_cat_and_pool_vs_conv3x3_psrp(by, nph, cins, cout):
    H = W = 16
    xs = [rand_int8(RNG, (2, H, W, c)) for c in cins]
    w = rand_int8(RNG, (3, 3, sum(cins), cout), -20, 20)
    scale, bias = _scales(cout)
    full, pooled = jp.conv3x3_psrp(
        tuple(jp.pack_psrp(jnp.asarray(x), by, nph) for x in xs),
        tuple(jnp.asarray(m) for m in jp.pack_psrp_weights(w, by, nph)[0]),
        jnp.asarray(scale), jnp.asarray(bias), by=by, nph=nph, cins=cins,
        tg=2, pool=True, interpret=True,
    )
    want = np.asarray(jp.unpack_psrp(full, by, nph))
    if nph == 2:
        want_pool = np.asarray(pooled).reshape(2, H // 2, W // 2, cout)
    else:
        want_pool = np.asarray(jp.unpack_psrp(pooled, by // 2, nph // 2))
    got, got_pool = _port_conv(xs, w, scale, bias, pool=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_pool.numpy(), want_pool)


@pytest.mark.parametrize("cout", [8, 32])  # 32: the served width
def test_k1_as_stem_vs_stem_psrp(cout):
    BY, by_out, nph = 8, 4, 4
    H = W = 32
    x = RNG.normal(0, 1, (2, H, W, 1)).astype(np.float32)
    w = rand_int8(RNG, (3, 3, 1, cout), -20, 20)
    s_in = np.float32(0.01)
    scale, bias = _scales(cout)
    xp = jp.prep_stem_input(jnp.asarray(x), s_in, BY=BY, nph=nph)
    mats, _ = jp.pack_stem_psrp_weights(w, BY, nph)
    want = jp.stem_psrp(
        xp, tuple(jnp.asarray(m) for m in mats), jnp.asarray(scale),
        jnp.asarray(bias), BY=BY, by_out=by_out, nph=nph, interpret=True,
    )
    want = np.asarray(jp.unpack_psrp(want, by_out, nph))
    xq = torch.round(_t(x) / torch.tensor(s_in)).clamp(-127, 127).to(
        torch.int8
    )
    got = _port_conv([xq.numpy()], w, scale, bias)
    np.testing.assert_array_equal(got.numpy(), want)


def _port_ct(x, w, scale, bias):
    wp = pack_ct2x2_weights(_t(w.transpose(2, 3, 0, 1)))
    return ct2x2_int8(_t(x), wp, _t(scale), _t(bias)).numpy()


@pytest.mark.parametrize("kernel", ["ct2x2_int8", "ct_up_psrp", "ct_psrp"])
def test_k2_vs_tpu_transpose_convs(kernel):
    cin, cout = 16, 8
    H = W = 8
    x = rand_int8(RNG, (2, H, W, cin))
    w = rand_int8(RNG, (2, 2, cin, cout), -20, 20)
    scale, bias = _scales(cout)
    xj, sj, bj = jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)
    if kernel == "ct2x2_int8":
        want = jk.ct2x2_int8(
            xj, tuple(jnp.asarray(m) for m in jk.pack_ct2x2_weights(w)),
            sj, bj, tr=4, interpret=True,
        )
    elif kernel == "ct_up_psrp":
        want = jp.unpack_psrp(jp.ct_up_psrp(
            xj, tuple(jnp.asarray(m) for m in jp.pack_ct_up_weights(w)),
            sj, bj, tr=4, interpret=True,
        ), 2, 2)
    else:
        want = jp.unpack_psrp(jp.ct_psrp(
            jp.pack_psrp(xj, 2, 2),
            tuple(jnp.asarray(m)
                  for m in jp.pack_ct_psrp_weights(w, by_in=2)),
            sj, bj, by_in=2, nph_in=2, tg=2, interpret=True,
        ), 4, 4)
    got = _port_ct(x, w, scale, bias)
    assert got.shape == (2, 2 * H, 2 * W, cout)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("cin,cout,nc", [(8, 8, 5), (32, 32, 10)])
def test_k1_fused_head_vs_conv3x3_psrp(cin, cout, nc):
    """K1 ending in the 1x1 head and argmax (blk8_conv1 + head) against
    ``conv3x3_psrp(head=...)`` in interpret mode, as
    tests/test_psrp_kernels.py's fused-head case; and equal to K1 then K3."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.head_argmax import (
        head_argmax,
        pack_head_weights,
    )

    by = nph = 4
    H = W = 16
    x = rand_int8(RNG, (2, H, W, cin))
    w = rand_int8(RNG, (3, 3, cin, cout), -20, 20)
    wh = rand_int8(RNG, (1, 1, cout, nc), -20, 20)
    scale, bias = _scales(cout)
    hs = RNG.uniform(1e-3, 2e-3, nc).astype(np.float32)
    hb = RNG.uniform(-0.5, 0.5, nc).astype(np.float32)
    fused = jp.conv3x3_psrp(
        (jp.pack_psrp(jnp.asarray(x), by, nph),),
        tuple(jnp.asarray(m) for m in jp.pack_psrp_weights(w, by, nph)[0]),
        jnp.asarray(scale), jnp.asarray(bias), by=by, nph=nph, cins=(cin,),
        tg=2, head=(jnp.asarray(jp.pack_head_psrp_weights(wh, by, ncp=16)),
                    hs, hb), interpret=True)
    want = np.asarray(fused.reshape(2, nph, by, H // by, W // nph)
                      .transpose(0, 3, 2, 4, 1).reshape(2, H, W))
    head = (pack_head_weights(_t(wh.transpose(3, 2, 0, 1))), _t(hs), _t(hb))
    got = _port_conv([x], w, scale, bias, head=head)
    assert got.dtype == torch.int8 and got.shape == (2, H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 1
    unfused = head_argmax(_port_conv([x], w, scale, bias), *head)
    assert torch.equal(got, unfused)
