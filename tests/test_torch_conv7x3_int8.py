"""K7 (``ops/conv7x3_int8.py``) on the CPU: its plain version bit for bit
against the JAX package's Pallas kernels in interpret mode,
``conv7x3_psrp`` (the parametrisation of tests/test_psrp7_kernels.py, 16^2,
with the fused index pool's values and indices) and ``stem7_psrp`` with
the pool at 64^2 (its BY=32 needs 32 | H).

The bit-exact target is the Pallas kernel in interpret mode: XLA contracts
its ``acc*scale + bias`` into one FMA there, which the plain version
emulates in float64 (and the CUDA kernel computes with ``__fmaf_rn``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_psrp import (
    pack_psrp,
    prep_stem_input,
    unpack_psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_psrp7 import (
    conv7x3_psrp,
    pack_psrp7_weights,
    stem7_psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv7x3_int8 as k7,
)
from test_torch_common import rand_int8


def _port_weights(w):
    """(kh, 3, cin, cout) JAX int8 weights -> K7's packing."""
    return k7.pack_conv7x3_weights(torch.from_numpy(w.transpose(3, 2, 0, 1)
                                                    .copy()))


def _epilogue(rng, cout):
    return (rng.uniform(1e-3, 2e-3, cout).astype(np.float32),
            rng.uniform(-3, 3, cout).astype(np.float32), 0.21)


@pytest.mark.parametrize("kh,by,nph,cins,cout,pool", [
    (7, 2, 2, (8,), 8, False),     # ReLayNet single-input family
    (7, 2, 2, (8, 8), 8, False),   # decoder folded-cat family
    (5, 2, 2, (8,), 4, False),     # other odd KH
    (3, 4, 4, (8,), 8, False),     # reduces to the 3x3 family
    (7, 1, 1, (8,), 8, False),     # by=1 (deep layout)
    (7, 2, 2, (8,), 8, True),      # fused index pool
    (7, 2, 2, (8, 8), 8, True),    # two inputs and the pool
])
def test_plain_k7_bit_exact_vs_conv7x3_psrp(kh, by, nph, cins, cout, pool):
    rng = np.random.default_rng(kh * 10 + by + len(cins) + 7 * pool)
    xs = [rand_int8(rng, (2, 16, 16, c)) for c in cins]
    w = rand_int8(rng, (kh, 3, sum(cins), cout), -10, 10)
    scale, bias, alpha = _epilogue(rng, cout)
    mats, _ = pack_psrp7_weights(w, by, nph, cins=cins)
    want = conv7x3_psrp(
        tuple(pack_psrp(jnp.asarray(x), by, nph) for x in xs),
        tuple(jnp.asarray(m) for m in mats), jnp.asarray(scale),
        jnp.asarray(bias), alpha, by=by, nph=nph, cins=cins, kh=kh, tg=4,
        pool=pool, interpret=True)
    got = k7.conv7x3_int8(tuple(torch.from_numpy(x) for x in xs),
                          _port_weights(w), torch.from_numpy(scale),
                          torch.from_numpy(bias), alpha, pool=pool)
    if not pool:
        want, got = (want,), (got,)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(unpack_psrp(want[0], by, nph)))
    assert (got[0] < 0).any() and (got[0] > 0).any()  # PReLU's both sides
    for g, wv in zip(got[1:], want[1:]):
        assert g.dtype == torch.int8
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def test_plain_k7_bit_exact_vs_stem7_psrp_with_pool():
    rng = np.random.default_rng(3)
    cout, s_in = 8, np.float32(0.02)
    x = rng.standard_normal((2, 64, 64, 1)).astype(np.float32)
    w = rand_int8(rng, (7, 3, 1, cout), -60, 60)
    scale, bias, alpha = _epilogue(rng, cout)
    scale *= 20
    mats, _ = pack_psrp7_weights(w, 32, 2)
    full, pooled, idx = stem7_psrp(
        prep_stem_input(jnp.asarray(x), s_in, BY=32, nph=2),
        tuple(jnp.asarray(m) for m in mats), jnp.asarray(scale),
        jnp.asarray(bias), alpha, BY=32, by_out=2, nph=2, kh=7, pool=True,
        interpret=True)
    xq = torch.round(torch.from_numpy(x) / torch.tensor(s_in)).clamp(
        -127, 127).to(torch.int8)
    got = k7.conv7x3_int8(xq, _port_weights(w), torch.from_numpy(scale),
                          torch.from_numpy(bias), alpha, pool=True)
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.asarray(unpack_psrp(full, 2, 2)))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(pooled))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(idx))
    assert len(np.unique(got[2].numpy())) == 4


def test_pack_round_trip_and_tie_order():
    """The packing inverts; on a window of equal values the index is 0 and
    a later strict maximum wins."""
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rand_int8(rng, (12, 5, 7, 3)))
    wk = k7.pack_conv7x3_weights(w)
    assert wk.shape == (21, 8, 32, 4)
    assert torch.equal(k7.unpack_conv7x3_weights(wk, 5, 12), w)
    x = torch.zeros((1, 2, 2, 1), dtype=torch.int8)
    one = k7.pack_conv7x3_weights(torch.zeros((1, 1, 7, 3),
                                              dtype=torch.int8))
    _, p, i = k7.conv7x3_int8(x, one, torch.ones(1), torch.zeros(1), 0.25,
                              pool=True)
    assert int(p) == 0 and int(i) == 0
    _, p, i = k7.conv7x3_int8(x, one, torch.ones(1), torch.full((1,), 2.0),
                              0.25, pool=True)
    assert int(p) == 2 and int(i) == 0


def test_wrapper_refuses_other_devices():
    """A tensor off the CPU never takes the plain version: it launches or
    raises (here on the meta device, before anything launches)."""
    x = torch.zeros((1, 4, 4, 4), dtype=torch.int8, device="meta")
    s = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k7.conv7x3_int8(x, x, s, s, 0.25)
