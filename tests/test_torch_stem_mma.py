"""K1's stem body (``csrc/conv3x3_int8.cu:conv3x3_int8_stem``) on the CPU:
its weight pack (taps folded into K, the output channels permuted), the
plan that routes the served graphs' stems to it, its tiles and shared
memory, the ctypes binding, and the body emulated in numpy (the halo
loader with its pad fill, every lane's A register by the kernel's funnel
shifts, the m16n8k32 s8 fragment maps, the channel map, the requant)
against ``conv3x3_int8_reference``, the version the kernel is held to on
the card.
"""

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
    build_model,
    build_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    packed,
    psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_int8 as k12,
)
from test_torch_conv3x3_mma import _a_matrix, _b_matrix, _fma, _mma, _rounded_byte

COUTS = (16, 32, 64)
_LANES = np.arange(32)
_G, _T = _LANES // 4, _LANES % 4


def _weights(cout, seed, lo=-127, hi=128):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.integers(lo, hi, (cout, 1, 3, 3)),
                        dtype=torch.int8)


# ---------------------------------------------------------------- (a) pack


@pytest.mark.parametrize("cout", COUTS)
def test_stem_pack_against_the_dp4a_words(cout):
    """Row n of the pack is channel ``stem_channel_order(cout)[n]``, byte
    4*ky + kx its tap (ky, kx) as in byte 0 of the dp4a body's word [3ky +
    kx, 0, channel]; bytes 4*ky + 3 and 12-15 are zero; the order is a
    permutation that gives GEMM columns 2t, 2t+1 of every n8 tile to lane
    t's cout/4 consecutive channels; the unpack inverts the pack."""
    w = _weights(cout, cout)
    wm = k12.pack_stem_mma_weights(w)
    assert wm.shape == (cout, k12.STEM_K) and wm.is_contiguous()
    order = k12.stem_channel_order(cout)
    assert sorted(order.tolist()) == list(range(cout))
    for j in range(cout // 8):
        for c in range(8):
            t, e = divmod(c, 2)
            assert order[8 * j + c] == (cout // 4) * t + 2 * j + e
    dp4a = k12.pack_conv3x3_weights(w)
    rows = wm.reshape(cout, 4, 4)
    for ky in range(3):
        for kx in range(3):
            np.testing.assert_array_equal(rows[:, ky, kx],
                                          dp4a[3 * ky + kx, 0, order, 0])
    assert not rows[:, :, 3].any() and not rows[:, 3].any()
    assert torch.equal(k12.unpack_stem_mma_weights(wm, cout), w)


@pytest.mark.parametrize("cout", COUTS + (8, 12))
def test_stem_weights_from_dp4a_equal_the_pack(cout):
    """The conversion a call without packed weights makes equals the pack
    (cout 12: rows of the channels past cout, to 16, are zero)."""
    w = _weights(cout, 100 + cout)
    wm = k12.pack_stem_mma_weights(w)
    assert torch.equal(
        k12.stem_weights_from_dp4a(k12.pack_conv3x3_weights(w), cout), wm)
    assert wm.shape[0] == -(-cout // 8) * 8
    assert int((wm != 0).sum()) == int((w != 0).sum())


# ---------------------------------------------------------------- (b) plan


def _graph_stem_plans(qparams, forward, monkeypatch, module, n, hw, **kw):
    """The plans of the K1 calls of one CPU forward whose input has one
    channel, as the wrapper would take them on the card."""
    plans = []
    real = module.conv3x3_int8

    def recorder(inputs, w, scale, bias, **knobs):
        if inputs[0].shape[-1] == 1:
            N, H, W, _ = inputs[0].shape
            plans.append(k12.conv3x3_plan(
                N, H, W, tuple(t.shape[-1] for t in inputs), scale.shape[0],
                knobs.get("head") is not None, True, knobs.get("pool", False)))
            assert knobs.get("w_mma") is not None  # packed at quantize time
        return real(inputs, w, scale, bias, **knobs)

    monkeypatch.setattr(module, "conv3x3_int8", recorder)
    x = torch.tensor(np.random.default_rng(0).standard_normal((n, hw, hw, 1)),
                     dtype=torch.float32)
    forward(qparams, x, 5, **kw)
    return plans


@pytest.fixture(scope="module")
def calibrated():
    """Layers and calibration taps of the served U-Net at f=16 and 32."""
    out = {}
    for f in (16, 32):
        model = build_model(num_classes=5, init_features=f, seed=0,
                            device="cpu")
        _, calib = build_psrp_forward(model, image_size=64, device="cpu")
        out[f] = calib
    return out


@pytest.mark.parametrize("graph,f", [("psrp", 16), ("psrp", 32),
                                     ("w4a4", 16), ("w4a4", 32),
                                     ("packed", 32)])
def test_plan_routes_the_served_stems(calibrated, monkeypatch, graph, f):
    """The one Cin=1 call of each served graph's forward (PSRP int8 and
    w4a4, packed) goes to the stem body at 64^2, and the same call at
    512^2 and batch 32 too; its qparams carry the stem pack as ``w_m``."""
    calib = calibrated[f]
    if graph == "psrp":
        qp, module, fwd = calib["qparams"], psrp, psrp.unet_psrp_forward
    elif graph == "w4a4":
        qp = psrp.quantize_unet_psrp(calib["layers"], calib["taps"], f,
                                     deep_int4=True, device="cpu")
        module, fwd = psrp, psrp.unet_psrp_forward
    else:
        qp = packed.quantize_unet_packed(calib["layers"], calib["taps"], f,
                                         device="cpu")
        module, fwd = packed, packed.unet_packed_forward
    assert torch.equal(qp["blk0_conv0"]["w_m"],
                       k12.pack_stem_mma_weights(qp["blk0_conv0"]["w_q"]))
    plans = _graph_stem_plans(qp, fwd, monkeypatch, module, 2, 64)
    assert [(p.body, p.cout, p.H, p.W) for p in plans] == [
        ("stem", f, 64, 64)]
    big = k12.conv3x3_plan(32, 512, 512, (1,), f, False, True, False)
    assert (big.body, big.co_t, big.warps, big.stages) == ("stem", f, 8, 2)
    assert big.grid == min(big.units, big.blocks_per_sm * k12.H100_SMS)


@pytest.mark.parametrize("h,w,cout,head,aligned,pool", [
    (64, 64, 8, False, True, False),     # cout 8: no whole n8 tile pair
    (64, 64, 48, False, True, False),    # 12 bytes a lane
    (64, 64, 128, False, True, False),
    (64, 40, 32, False, True, False),    # W not a multiple of 16
    (64, 64, 32, False, False, False),   # a misaligned input
    (64, 64, 32, False, True, True),     # a pool
    (64, 64, 32, True, True, False),     # a head
    (64, 12000, 32, False, True, False),  # a halo wider than the SM holds
])
def test_plan_keeps_other_stems_on_dp4a(h, w, cout, head, aligned, pool):
    plan = k12.conv3x3_plan(2, h, w, (1,), cout, head, aligned, pool)
    assert plan.body == "dp4a"


@pytest.mark.parametrize("n,h,w,cout", [
    (32, 512, 512, 32), (32, 512, 512, 16), (8, 512, 512, 64),
    (2, 80, 48, 32), (1, 20, 16, 16), (3, 7, 32, 64), (1, 512, 11584, 32),
])
def test_stem_tiles_cover_the_output(n, h, w, cout):
    """Block b takes tiles b, b + grid, ...: every tile once; the tiles'
    rows (one a warp) cover every output row once and each tile's pixels
    are whole rows of all cout channels; the resident blocks' shared
    memory (two halo buffers) fits an SM."""
    plan = k12.conv3x3_plan(n, h, w, (1,), cout)
    assert plan.body == "stem" and plan.rows == k12.STEM_WARPS
    assert plan.smem == k12.stem_smem(w)
    assert 1 <= plan.blocks_per_sm <= (4 if cout <= 32 else 2)
    assert plan.blocks_per_sm * (plan.smem + k12.BLOCK_SMEM_RESERVED) \
        <= k12.SM_SMEM
    assert plan.tiles_x == 1 and plan.n_co == 1
    seen = np.zeros((n, plan.tiles_y * plan.rows), np.int32)
    taken = np.zeros(plan.units, np.int32)
    for b in range(plan.grid):
        for u in range(b, plan.units, plan.grid):
            taken[u] += 1
            img, ty = divmod(u, plan.tiles_y)
            seen[img, ty * plan.rows:(ty + 1) * plan.rows] += 1
    assert (taken == 1).all()
    assert (seen == 1).all() and seen.shape[1] - h < plan.rows


def test_stem_binding_matches_the_c_entry_point():
    """The ctypes argument list of K1's stem entry point has one entry per
    parameter of the C function, pointers where it takes pointers, floats
    where it takes floats."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    src = (_build.CSRC / "conv3x3_int8.cu").read_text()
    params = re.search(r'extern "C" int octseg_conv3x3_int8_stem\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_conv3x3_int8_stem"]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
        assert ("float" in p) == (t is ctypes.c_float), (p, t)


# ----------------------------------------------------- (c) the emulated body


def _funnelshift_r(lo, hi, shift):
    """``__funnelshift_r``: the low word of (hi:lo) >> shift."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> shift.astype(np.uint64)) & np.uint64(0xFFFFFFFF)).astype(
        np.uint32)


def _bytes(words):
    """(32,) uint32 -> (32, 4) int8, low byte first."""
    return words.astype("<u4").view(np.int8).reshape(32, 4)


def _emulate_stem(x, wm, scale, bias, plan, *, relu=True, out_clip=127.0,
                  pad=0):
    """The stem body at ``plan``, block by block in the kernel's order:
    the loader's copies of tile u + grid's halo into the other buffer (16
    bytes a unit, the pad value outside the image), then each warp's row of
    tile u: per 16 pixels, each lane's A words and funnel shift, one
    product a n8 tile, the requant, the lane's cout/4 bytes of pixels g
    and g + 8. Returns the output and how often each byte was written."""
    N, H, W, _ = x.shape
    cout = plan.cout
    NT, CPL = cout // 8, cout // 4
    pitch = W + 2 * k12.STEM_PAD
    units, buf = pitch // 16, (k12.STEM_WARPS + 2) * pitch
    smem = np.full(2 * buf, 0xA5, np.uint8)  # stale bytes a bad read shows
    words = wm.view(np.uint32).reshape(cout, k12.STEM_K // 4)
    b = [_bytes(words[8 * j + _G, _T]) for j in range(NT)]
    zeros = np.zeros((32, 4), np.int8)
    sc = scale.reshape(4, CPL)[_T]
    bi = bias.reshape(4, CPL)[_T]
    lo = 0.0 if relu else -out_clip
    out = np.zeros((N, H, W, cout), np.uint8)
    count = np.zeros(out.shape, np.int32)
    xb = x.view(np.uint8)

    def issue(u, s):
        if u >= plan.units:
            return
        n, ty = divmod(u, plan.tiles_y)
        for hr in range(k12.STEM_WARPS + 2):
            iy = ty * k12.STEM_WARPS - 1 + hr
            for c in range(units):
                dst = s * buf + hr * pitch + 16 * c
                if 0 <= iy < H and 1 <= c < units - 1:
                    smem[dst:dst + 16] = xb[n, iy, 16 * (c - 1):16 * c, 0]
                else:
                    smem[dst:dst + 16] = np.uint8(pad & 0xFF)

    word = (k12.STEM_PAD - 1 + _G) >> 2
    shift = 8 * ((k12.STEM_PAD - 1 + _G) & 3)
    for blk in range(plan.grid):
        issue(blk, 0)
        s = 0
        for u in range(blk, plan.units, plan.grid):
            issue(u + plan.grid, s ^ 1)
            n, ty = divmod(u, plan.tiles_y)
            sw = smem[s * buf:(s + 1) * buf].view("<u4")
            for warp in range(k12.STEM_WARPS):
                oy = ty * k12.STEM_WARPS + warp
                if oy >= H:
                    continue
                row = ((warp + np.minimum(_T, 2)) * pitch) // 4 + word
                for x0 in range(0, W, 16):
                    p = [sw[row + x0 // 4 + k] for k in range(4)]
                    a = np.zeros((32, 4, 4), np.int8)
                    a[:, 0] = _bytes(_funnelshift_r(p[0], p[1], shift))
                    a[:, 1] = _bytes(_funnelshift_r(p[2], p[3], shift))
                    A = _a_matrix(a)
                    for j in range(NT):
                        acc = np.zeros((32, 4), np.int64)
                        _mma(acc, A, _b_matrix(b[j], zeros))
                        for h in range(2):
                            for e in range(2):
                                i = 2 * j + e
                                v = _fma(acc[:, 2 * h + e], sc[:, i],
                                         bi[:, i])
                                px = x0 + _G + 8 * h
                                ch = CPL * _T + i
                                out[n, oy, px, ch] = _rounded_byte(
                                    v, lo, out_clip)
                                count[n, oy, px, ch] += 1
            s ^= 1
    return out.view(np.int8), count


def _stem_case(name, cout):
    """(x, w_q, scale, bias, knobs) of one emulated case."""
    rng = np.random.default_rng(cout + len(name))
    if name == "extremes":  # +-127 inputs and weights: |acc| up to 9 * 127^2
        x = rng.choice([-127, 127], (2, 24, 32, 1))
        w = rng.choice([-127, 127], (cout, 1, 3, 3))
        w[0] = 127
        x[0, 4:7, 4:7] = 127  # one pixel of channel 0 at 9 * 127^2
        scale = rng.uniform(30, 60, cout) / (3 * 127 ** 2)
        bias = rng.uniform(-5, 5, cout)
        knobs = {}
    elif name == "borders":
        # positive inputs and weights, no clip reached: a border pixel sums
        # fewer taps than the interior, a corner fewer still, so a wrong
        # halo column or row changes its value
        x = rng.integers(100, 128, (1, 20, 48, 1))
        w = rng.integers(1, 128, (cout, 1, 3, 3))
        scale = rng.uniform(100, 120, cout) / (9 * 127 ** 2)
        bias = np.full(cout, -20.0) + rng.uniform(-1, 1, cout)
        knobs = {}
    elif name == "pad7":  # border value -7, no relu, clip 7
        x = rng.integers(-127, 128, (2, 16, 32, 1))
        w = rng.integers(-127, 128, (cout, 1, 3, 3))
        scale = rng.uniform(6, 12, cout) / (3 * 73 ** 2)
        bias = rng.uniform(-2, 2, cout)
        knobs = {"relu": False, "out_clip": 7.0, "pad": -7}
    else:  # random
        x = rng.integers(-127, 128, (2, 24, 32, 1))
        w = rng.integers(-127, 128, (cout, 1, 3, 3))
        scale = rng.uniform(30, 60, cout) / (3 * 73 ** 2)
        bias = rng.uniform(-5, 5, cout)
        knobs = {}
    return (x.astype(np.int8), torch.tensor(w, dtype=torch.int8),
            scale.astype(np.float32), bias.astype(np.float32), knobs)


@pytest.mark.parametrize("cout", COUTS)
@pytest.mark.parametrize("name", ["random", "extremes", "borders", "pad7"])
def test_emulated_stem_equals_the_plain_version(name, cout):
    """The body emulated over every tile of a small batch, by two
    persistent blocks (each walks several tiles through both halo
    buffers; the last tile of 20 rows has 4 rows past the image), equals
    ``conv3x3_int8_reference`` bit for bit and writes every output byte
    once."""
    x, w, scale, bias, knobs = _stem_case(name, cout)
    N, H, W, _ = x.shape
    plan = k12.conv3x3_plan(N, H, W, (1,), cout)._replace(grid=2)
    assert plan.body == "stem" and plan.units > plan.grid
    ref_knobs = {k: v for k, v in knobs.items() if k != "pad"}
    if "pad" in knobs:
        ref_knobs["pad_vals"] = (knobs["pad"],)
    want = k12.conv3x3_int8_reference(
        (torch.from_numpy(x),), k12.pack_conv3x3_weights(w),
        torch.from_numpy(scale), torch.from_numpy(bias), **ref_knobs).numpy()
    got, count = _emulate_stem(x, k12.pack_stem_mma_weights(w).numpy(),
                               scale, bias, plan, **knobs)
    assert (count == 1).all()
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 3  # not all clipped
    if name == "extremes":  # the clip reached, pixel (5, 5) at 9 * 127^2
        assert int(want.max()) == 127
    if name == "borders":  # the border rows and columns differ inward
        inner = want[0, 1:-1, 1:-1].astype(np.int32)
        assert (want[0, 0, 1:-1] < inner[0]).mean() > 0.5
        assert (want[0, 1:-1, -1] < inner[:, -1]).mean() > 0.5
