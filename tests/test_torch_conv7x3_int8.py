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
    assert wk.shape == (1, 21, 32, 32)  # (K chunks, taps, coutp, 32 bytes)
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


@pytest.mark.parametrize("kh", [3, 5, 7])
@pytest.mark.parametrize("cin", [1, 5, 12, 64, 128])
def test_pack_round_trip(kh, cin):
    """The tensor-core packing inverts at every window height, for the
    stem's im2col words (cin <= 4) and the K-chunked rows, cout 3, 40, 64;
    its shape is ``packed_shape``."""
    rng = np.random.default_rng(kh * 1000 + cin)
    for cout in (3, 40, 64):
        w = torch.from_numpy(rand_int8(rng, (cout, cin, kh, 3)))
        wk = k7.pack_conv7x3_weights(w)
        assert tuple(wk.shape) == k7.packed_shape(cin, cout, kh)
        assert k7._kh(wk) == kh
        assert torch.equal(k7.unpack_conv7x3_weights(wk, cin, cout), w)


def _relaynet_stage_calls(f, hw=512, n=32):
    return [(n, hw, hw, (1,), f, True), (n, hw // 2, hw // 2, (f,), f, True),
            (n, hw // 4, hw // 4, (f,), f, True),
            (n, hw // 8, hw // 8, (f,), f, False),
            (n, hw // 4, hw // 4, (f, f), f, False),
            (n, hw // 2, hw // 2, (f, f), f, False),
            (n, hw, hw, (f, f), f, False)]


# every call of tests/test_torch_cuda.py::test_k7_matches_plain
CARD_CALLS = [(2, 16, 16, (1,), 64, True), (1, 6, 10, (5,), 3, False),
              (2, 34, 18, (64,), 64, True), (1, 20, 36, (64, 64), 64, False),
              (1, 12, 8, (8, 4), 40, True), (1, 7, 9, (32,), 32, False),
              (1, 40, 72, (64, 64), 64, False)]


@pytest.mark.parametrize(
    "n,h,w,cins,cout,pool",
    _relaynet_stage_calls(64) + _relaynet_stage_calls(8) + CARD_CALLS)
def test_plan_fits_and_aligns(n, h, w, cins, cout, pool):
    """Every plan fits the shared memory of an H100 block; with the pool,
    tiles have even sizes and origins (whole 2x2 windows); the grid covers
    every tile once; the loader is cp.async wherever the channel counts
    allow, and ReLayNet's f=64 stages use it."""
    kh = 5 if cins == (8, 4) else 3 if cins == (32,) else 7
    plan = k7.conv7x3_plan(n, h, w, cins, cout, kh, pool)
    assert plan.smem <= k7.SMEM_MAX
    assert plan.rows % 2 == 0 and k7.COLS % 2 == 0
    cin = sum(cins)
    if cin <= 4:
        assert plan.taps == 1 and plan.nk * k7.KCHUNK >= kh * 3 * 4
        assert plan.loader in ("im2col_async", "im2col_gather")
        assert 1 <= plan.blocks <= n * plan.tiles
    else:
        assert plan.taps == kh * 3 and plan.nk * k7.KCHUNK >= cin
        assert plan.stages in (2, 3)
        assert plan.blocks == plan.tiles
        assert plan.loader == ("async" if all(c % 32 == 0 for c in cins)
                               else "gather")
    assert plan.coutp % plan.co_t == 0 and plan.coutp >= cout
    if cins in ((64,), (64, 64)) or (cins == (1,) and w % 16 == 0):
        assert plan.loader in ("async", "im2col_async")
    if cins == (64, 64) and h >= 64:
        assert plan.stages == 3  # four chunks: a copy in flight during two


def test_plan_falls_back_to_gathers_when_misaligned():
    assert k7.conv7x3_plan(1, 32, 32, (64,), 64, 7, False,
                           aligned=False).loader == "gather"
    assert k7.conv7x3_plan(1, 32, 24, (1,), 64, 7, True).loader == \
        "im2col_gather"  # a 24-byte image row is not whole 16-byte units


def test_k7_binding_matches_the_c_entry_point():
    """The ctypes argument list of K7 (``ops/_build.py``) has one entry per
    parameter of its C entry point, pointers where the C side takes
    pointers, and a float for the slope."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    src = (_build.CSRC / "conv7x3_int8.cu").read_text()
    params = re.search(r'extern "C" int octseg_conv7x3_int8\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_conv7x3_int8"]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
        assert ("float" in p) == (t is ctypes.c_float), (p, t)


def _swz(p, u):
    """csrc/conv7x3_int8.cu:swz: byte offset of 16-byte unit u of 32-byte
    row p."""
    return ((2 * p + u) ^ ((p >> 2) & 1)) * 16


@pytest.mark.parametrize("kh", [3, 5, 7])
def test_swizzle_keeps_ldmatrix_conflict_free(kh):
    """Emulates the kernel's ldmatrix addresses: for every tap (ky, kx),
    tile row and 16-pixel half, the 8 rows of each ldmatrix phase (8
    consecutive halo pixels at one 16-byte unit) fall in 8 different bank
    groups; so do the B phases (8 consecutive output channels of a tap);
    the swizzle is a permutation within each row pair."""
    lanes = np.arange(32)
    pitch = (k7.COLS + 2) * k7.KCHUNK
    for ky in range(kh):
        for kx in range(3):
            for row in range(k7.ROWS):
                col = kx + (lanes & 7) + 8 * ((lanes >> 3) & 1)
                addr = (row + ky) * pitch + _swz(col, lanes >> 4)
                for phase in range(4):
                    groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                    assert len(set(groups.tolist())) == 8, (ky, kx, row)
    for co_t in (32, 64):
        for tap in range(kh * 3):
            for j in range(co_t // 16):
                co = 16 * j + (lanes & 7) + 8 * (lanes >> 4)
                addr = tap * co_t * k7.KCHUNK + _swz(co, (lanes >> 3) & 1)
                for phase in range(4):
                    groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                    assert len(set(groups.tolist())) == 8
    p = np.arange(64)
    for u in (0, 1):
        assert sorted(_swz(p, u) // 16 // 2) == list(range(64))
    assert len(set(_swz(p, 0).tolist() + _swz(p, 1).tolist())) == 128
