"""K10's tensor-core body (``csrc/stem_conv_int8.cu:stem_conv_int8_mma``) on
the CPU: ``stem_conv_plan`` (which calls it takes, its shared memory and
occupancy, its bands and persistent grid), the ctypes binding, the
served graph handing it the qparams' tensor-core packs, and the body
emulated in numpy block by block: the image rows with their zero fill,
the stem's m16n8k32 s8 fragments, its 8-byte stores into the swizzled
ring of stem rows (and their bank groups), the zero rows outside the
image, conv1's ldmatrix reads and products over the ring, the requant,
the 8-byte stores and the byte-max pool, against
``stem_conv_int8_reference``, the version the kernel is held to on the
card.
"""

import ctypes
import re

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
    build_model,
    build_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    _build,
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
from test_torch_conv3x3_mma import (
    _a_matrix,
    _b_matrix,
    _fma,
    _lane_offsets,
    _ldmatrix_x4,
    _mma,
    _rounded_byte,
    _swz,
)
from test_torch_stem_mma import _bytes, _funnelshift_r

_LANES = np.arange(32)
_G, _T = _LANES // 4, _LANES % 4
ROWS, COLS, CH, RING = k10.MMA_ROWS, k10.MMA_COLS, k10.MMA_C, k10.RING
PAD = k10.IMG_PAD


def _perm(n):
    """The output channel of conv1's GEMM column n (the stem pack's order,
    ``stem_channel_order(32)``)."""
    return 8 * ((n & 7) >> 1) + 2 * (n >> 3) + (n & 1)


# ---------------------------------------------------------------- (a) plan


def test_plan_routes_the_served_f32_stem_to_the_mma_body():
    """The served fused stem (batch 32 and 128, 512^2, f=32) and the chip
    checks' shapes take the mma.sync body, two blocks an SM; f=16 and
    every other c1 stay on the dp4a body."""
    big = k10.stem_conv_plan(32, 512, 512, 32, 32)
    assert (big.body, big.band, big.grid, big.blocks_per_sm) == (
        "mma", 64, 256, 2)
    assert big.units == 256 and big.recompute == pytest.approx(66 / 64)
    assert k10.stem_conv_plan(128, 512, 512, 32, 32).body == "mma"
    for n, h, w in ((2, 512, 512), (2, 80, 48)):
        assert k10.stem_conv_plan(n, h, w, 32, 32).body == "mma"
    for args in ((2, 512, 512, 16, 16), (2, 80, 48, 16, 16),
                 (1, 20, 14, 3, 40), (2, 64, 64, 32, 16),
                 (2, 64, 64, 16, 32), (2, 64, 40, 32, 32),
                 (2, 512, 11584, 32, 32)):
        assert k10.stem_conv_plan(*args).body == "dp4a", args
    assert k10.stem_conv_plan(2, 64, 64, 32, 32, aligned=False).body == \
        "dp4a"


@pytest.mark.parametrize("w", [16, 48, 512, 1024, 1056])
def test_shared_memory_and_occupancy(w):
    """The block's shared memory is the ring of 6 stem rows of W + 2
    pixels x 32 bytes, conv1's 9 x 32 x 32 weight bytes, 8 image rows of W
    + 32 bytes, 4 x 32 floats (scales and biases) and the stem's 32 x 16
    weight bytes; two blocks an SM up to 512 columns, one where only one
    fits, each within an H100 SM."""
    plan = k10.stem_conv_plan(2, 64, w, 32, 32)
    smem = 6 * (w + 2) * 32 + 9 * 32 * 32 + 8 * (w + 32) + 4 * 32 * 4 + 512
    assert plan.body == "mma" and plan.smem == smem
    assert plan.blocks_per_sm == (2 if w <= 512 else 1)
    assert plan.blocks_per_sm * (smem + k12.BLOCK_SMEM_RESERVED) \
        <= k12.SM_SMEM
    assert 2 * (smem + k12.BLOCK_SMEM_RESERVED) > k12.SM_SMEM or w <= 512
    assert plan.smem % 16 == 0  # the epilogue vectors' float4 reads


@pytest.mark.parametrize("n,h,w", [(32, 512, 512), (128, 512, 512),
                                   (2, 512, 512), (2, 80, 48), (3, 14, 32),
                                   (1, 6, 16)])
def test_units_cover_every_row_once(n, h, w):
    """Block b takes units b, b + grid, ...: every unit once; each unit's
    steps of 4 rows cover its band's output rows once; its stem rows (6
    at the first step, 4 at each later one) are rows Y - 1 .. Y + 4s of
    the unit's first row Y, each once, and every step's conv1 finds its 6
    rows y0 - 1 .. y0 + 4 in 6 different ring slots, written in this unit
    and not overwritten since. The band is the one that minimises waves x
    (band + 2)."""
    plan = k10.stem_conv_plan(n, h, w, 32, 32)
    slots = plan.blocks_per_sm * k12.H100_SMS
    assert plan.grid == min(plan.units, slots)
    tall = -(-h // 4) * 4
    cost = {b: -(-(n * -(-h // b)) // slots) * (b + 2)
            for b in [4 << i for i in range(12) if 4 << i < tall] + [tall]}
    assert cost[plan.band] == min(cost.values())
    taken = np.zeros(plan.units, np.int32)
    seen = np.zeros((n, h), np.int32)
    stem_rows = 0
    for b in range(plan.grid):
        for u in range(b, plan.units, plan.grid):
            taken[u] += 1
            img, bi = divmod(u, plan.bands)
            Y = bi * plan.band
            ring = {}  # slot -> the stem row it holds
            for k in range(plan.steps(u)):
                y0 = Y + 4 * k
                new = range(y0 - 1, y0 + 5) if k == 0 else range(y0 + 1,
                                                                   y0 + 5)
                for r in new:
                    ring[(r - Y + 1) % RING] = r
                stem_rows += len(new)
                slots_read = [(y0 - Y + i) % RING for i in range(RING)]
                assert len(set(slots_read)) == RING
                assert [ring[s] for s in slots_read] == list(
                    range(y0 - 1, y0 + 5))
                for m in range(4):
                    if y0 + m < h:
                        seen[img, y0 + m] += 1
            assert Y + 4 * plan.steps(u) >= min(Y + plan.band, h)
    assert (taken == 1).all() and (seen == 1).all()
    assert stem_rows == plan.stem_rows


def test_mma_binding_matches_the_c_entry_point():
    """The ctypes argument list of K10's mma.sync entry point has one
    entry per parameter of the C function, pointers where it takes
    pointers, floats where it takes floats."""
    src = (_build.CSRC / "stem_conv_int8.cu").read_text()
    params = re.search(r'extern "C" int octseg_stem_conv_int8_mma\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_stem_conv_int8_mma"]
    assert len(params) == len(argtypes) == 16
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
        assert ("float" in p) == (t is ctypes.c_float), (p, t)


# ------------------------------------------------------------- (b) the graph


def test_fused_graph_hands_k10_the_tensor_core_packs(monkeypatch):
    """With the fused stem the served graph (f=32) calls K10 with the
    qparams' ``w_m`` packs of the stem and blk0_conv1 (the stem body's and
    the mma.sync body's), which the plan admits at the graph's shape; the
    labels equal the unfused graph's."""
    model = build_model(num_classes=5, init_features=32, seed=0,
                        device="cpu")
    _, calib = build_psrp_forward(model, image_size=32, device="cpu")
    qp = calib["qparams"]
    l0, l1 = qp["blk0_conv0"], qp["blk0_conv1"]
    assert torch.equal(l0["w_m"], k12.pack_stem_mma_weights(l0["w_q"]))
    assert torch.equal(l1["w_m"], k12.pack_conv3x3_mma_weights(l1["w_q"]))
    x = preprocess(torch.tensor(
        np.random.default_rng(3).uniform(0, 255, (2, 32, 32, 1)),
        dtype=torch.float32))
    calls = []
    real = k10.stem_conv_int8

    def recorder(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(psrp, "stem_conv_int8", recorder)
    fused = psrp.unet_psrp_forward(qp, x, 5, stem_fuse=True)
    assert len(calls) == 1
    img, w_mma = calls[0][0], calls[0][7]
    assert w_mma[0] is l0["w_m"] and w_mma[1] is l1["w_m"]
    assert k10.stem_conv_plan(*img.shape[:3], 32, 32).body == "mma"
    assert torch.equal(fused, psrp.unet_psrp_forward(qp, x, 5,
                                                     stem_fuse=False))


# ------------------------------------------------------ (c) the emulated body


def _max_bytes(a, b):
    """The kernel's ``max_bytes`` on uint32 words whose bytes are 0..127:
    (a | 0x80) - b per byte has its top bit set where a >= b, spread over
    the byte (prmt's sign mode), then a where set, else b."""
    d = ((a | np.uint32(0x80808080)) - b).astype(np.uint32)
    ge = ((d >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(0xFF)
    return (a & ge) | (b & ~ge)


def test_max_bytes_is_the_byte_max():
    """``max_bytes`` equals the bytewise max for every pair of bytes in
    0..127, in every byte position."""
    v = np.arange(128, dtype=np.uint32)
    a, b = np.meshgrid(v, v)
    a, b = a.ravel(), b.ravel()
    for shift in (0, 8, 16, 24):
        other = np.uint32(0x35) << np.uint32((shift + 8) % 32)
        got = _max_bytes((a << np.uint32(shift)) | other,
                         (b << np.uint32(shift)) | other)
        np.testing.assert_array_equal(got, (np.maximum(a, b)
                                            << np.uint32(shift)) | other)


def _emulate(x, w0m, s0, b0, w1m, s1, b1, plan, ring_watch=None):
    """The mma.sync body at ``plan``, block by block in the kernel's
    order: the block's set-up (conv1's weights in the permuted channel
    order, swizzled; the ring's zero columns; the image rows' zero pads),
    then per step of its units: the stem rows' 16-pixel products (each
    lane's A words by funnel shifts), their requant and each lane's two
    8-byte stores into the ring (zeros for a row outside the image), the
    next step's image rows, then each warp tile's conv1 (ldmatrix and
    products per kx, each halo row once), requant, 8-byte stores and
    byte-max pool (a lane^4 exchange). ``ring_watch``: a list that gets
    (stem row, the ring slot's bytes) for every stem row outside the
    image. Returns (y, yp, how often each byte of each was written)."""
    N, H, W, _ = x.shape
    gw, rp, ip = W // COLS, (W + 2) * CH, W + 2 * PAD
    w1_off = RING * rp
    img_off = w1_off + 9 * CH * CH
    y = np.zeros((N, H, W, CH), np.uint8)
    yp = np.zeros((N, H // 2, W // 2, CH), np.uint8)
    cy, cyp = np.zeros(y.shape, np.int32), np.zeros(yp.shape, np.int32)
    xb = x.view(np.uint8)[..., 0]
    words0 = w0m.view("<u4").reshape(CH, 4)
    zeros = np.zeros((32, 4), np.int8)
    b0f = [_b_matrix(_bytes(words0[8 * j + _G, _T]), zeros) for j in range(4)]
    a_col, b_off = _lane_offsets(4)
    word = (PAD - 1 + _G) >> 2
    shift = 8 * ((PAD - 1 + _G) & 3)
    ky_row = np.minimum(_T, 2)
    sc0, bi0 = s0.reshape(4, 8)[_T], b0.reshape(4, 8)[_T]  # lane t: 8t..
    sc1, bi1 = s1.reshape(4, 8)[_T], b1.reshape(4, 8)[_T]
    eight = np.arange(8)
    for blk in range(plan.grid):
        smem = np.full(plan.smem, 0xA5, np.uint8)  # stale bytes show
        for e in range(9 * CH * 2):
            u, r = e & 1, e >> 1
            tap, nn = divmod(r, CH)
            dst = w1_off + tap * CH * CH + _swz(nn, u)
            smem[dst:dst + 16] = w1m[0, tap, _perm(nn), 16 * u:16 * u + 16] \
                .view(np.uint8)
        for s in range(RING):
            for col in (0, W + 1):
                for u in (0, 1):
                    dst = s * rp + _swz(col, u)
                    smem[dst:dst + 16] = 0
        for r in range(RING + 2):
            smem[img_off + r * ip:img_off + r * ip + PAD] = 0
            smem[img_off + r * ip + PAD + W:img_off + (r + 1) * ip] = 0

        def issue(u, k):
            if u >= plan.units:
                return
            n, bi = divmod(u, plan.bands)
            y0 = bi * plan.band + ROWS * k
            first = y0 if k else y0 - 2
            for i in range((ROWS if k else RING) + 2):
                iy, dst = first + i, img_off + i * ip + PAD
                smem[dst:dst + W] = xb[n, iy] if 0 <= iy < H else 0

        u, k = blk, 0
        issue(u, 0)
        while u < plan.units:
            n, bi = divmod(u, plan.bands)
            Y = bi * plan.band
            y0 = Y + ROWS * k
            nu, nk = u, k + 1
            if nk == plan.steps(u):
                nu, nk = u + plan.grid, 0
            # the stem
            r0, rows = (y0 + 1, ROWS) if k else (y0 - 1, RING)
            img = smem[img_off:img_off + (RING + 2) * ip].view("<u4")
            for q in range(rows * gw):
                i, c = divmod(q, gw)
                r = r0 + i
                row = ((r - Y + 1) % RING) * rp
                out = np.zeros((2, 32, 8), np.uint8)
                if 0 <= r < H:
                    w_at = ((i + ky_row) * ip) // 4 + word + 4 * c
                    p = [img[w_at + kk] for kk in range(4)]
                    a = np.zeros((32, 4, 4), np.int8)
                    a[:, 0] = _bytes(_funnelshift_r(p[0], p[1], shift))
                    a[:, 1] = _bytes(_funnelshift_r(p[2], p[3], shift))
                    A = _a_matrix(a)
                    for j in range(4):
                        acc = np.zeros((32, 4), np.int64)
                        _mma(acc, A, b0f[j])
                        for h in range(2):
                            for e in range(2):
                                out[h, :, 2 * j + e] = _rounded_byte(
                                    _fma(acc[:, 2 * h + e], sc0[:, 2 * j + e],
                                         bi0[:, 2 * j + e]), 0.0, 127.0)
                for h in range(2):
                    dst = (row + _swz(16 * c + _G + 8 * h + 1, _T >> 1)
                           + 8 * (_T & 1))
                    smem[dst[:, None] + eight] = out[h]
                if ring_watch is not None and not 0 <= r < H and c == gw - 1:
                    ring_watch.append((r, smem[row:row + rp].copy()))
            issue(nu, nk)
            # conv1 on each warp tile, its requant, stores and pool
            slot = [((y0 - Y + i) % RING) * rp for i in range(RING)]
            for c in range(gw):
                acc = np.zeros((ROWS, 4, 32, 4), np.int64)
                for kx in range(3):
                    B = []
                    for ky in range(3):
                        bt = w1_off + (ky * 3 + kx) * CH * CH
                        B.append([])
                        for jj in range(2):
                            rr = _ldmatrix_x4(smem, bt + b_off[jj])
                            B[ky] += [_b_matrix(rr[:, 0], rr[:, 1]),
                                      _b_matrix(rr[:, 2], rr[:, 3])]
                    for hr in range(RING):
                        A = _a_matrix(_ldmatrix_x4(
                            smem, slot[hr] + c * COLS * CH + a_col[kx]))
                        for ky in range(3):
                            if 0 <= hr - ky < ROWS:
                                for t in range(4):
                                    _mma(acc[hr - ky, t], A, B[ky][t])
                o = np.zeros((ROWS, 2, 32, 8), np.uint8)
                for m in range(ROWS):
                    for h in range(2):
                        for j in range(4):
                            for e in range(2):
                                o[m, h, :, 2 * j + e] = _rounded_byte(
                                    _fma(acc[m, j, :, 2 * h + e],
                                         sc1[:, 2 * j + e],
                                         bi1[:, 2 * j + e]), 0.0, 127.0)
                chans = (8 * _T)[:, None] + eight
                for m in range(ROWS):
                    if y0 + m >= H:
                        break
                    for h in range(2):
                        cols = (COLS * c + _G + 8 * h)[:, None]
                        y[n, y0 + m, cols, chans] = o[m, h]
                        np.add.at(cy, (n, y0 + m, cols, chans), 1)
                hh = _G & 1
                for m in range(0, ROWS, 2):
                    if y0 + m >= H:
                        break
                    words = o.view("<u4")  # (ROWS, 2, 32, 2)
                    mx = _max_bytes(words[m], words[m + 1])
                    mx = _max_bytes(mx, mx[:, _LANES ^ 4])
                    cols = (8 * c + 4 * hh + (_G >> 1))[:, None]
                    yp[n, (y0 + m) // 2, cols, chans] = \
                        mx[hh, _LANES].view(np.uint8)
                    np.add.at(cyp, (n, (y0 + m) // 2, cols, chans), 1)
            u, k = nu, nk
    return y.view(np.int8), yp.view(np.int8), cy, cyp


def _k10_case(name):
    """(x, w0 (32, 1, 3, 3), w1 (32, 32, 3, 3), s0, b0, s1, b1) of one
    emulated case, numpy."""
    rng = np.random.default_rng(len(name))
    n, h, w = {"ragged": (2, 14, 48), "borders": (1, 12, 32)}.get(
        name, (2, 16, 32))
    if name == "extremes":
        # +-127 image and weights; a 3x3 block of 127s whose stem clips at
        # 127 in every channel, where channel 0 of conv1 (all 127) reaches
        # 288 * 127^2 > 2^22 at the block's centre
        x = rng.choice([-127, 127], (n, h, w, 1))
        x[0, 4:11, 4:11] = 127
        w0 = np.full((32, 1, 3, 3), 127)
        w1 = rng.choice([-127, 127], (32, 32, 3, 3))
        w1[0] = 127
        s0 = rng.uniform(1.0, 1.5, 32) / (9 * 127)
        b0 = rng.uniform(-5, 5, 32)
        s1 = rng.uniform(30, 60, 32) / (17 * 64 * 127)
        b1 = rng.uniform(-5, 5, 32)
    elif name == "borders":
        # stem biases 10-40: the stem of a zero-padded image (a halo that
        # is not conv1's zero padding) would be relu(rint(bias0)) > 0 and
        # change every border output
        x = rng.integers(-127, 128, (n, h, w, 1))
        w0 = rng.integers(-40, 40, (32, 1, 3, 3))
        w1 = rng.integers(-40, 40, (32, 32, 3, 3))
        s0, b0 = rng.uniform(0.05, 0.1, 32), rng.uniform(10, 40, 32)
        s1, b1 = rng.uniform(1e-3, 3e-3, 32), rng.uniform(-5, 5, 32)
    else:
        x = rng.integers(-127, 128, (n, h, w, 1))
        w0 = rng.integers(-127, 128, (32, 1, 3, 3))
        w1 = rng.integers(-127, 128, (32, 32, 3, 3))
        s0 = rng.uniform(30, 60, 32) / (3 * 73 ** 2)
        b0 = rng.uniform(-5, 5, 32)
        s1 = rng.uniform(30, 60, 32) / (17 * 64 * 73)
        b1 = rng.uniform(-5, 5, 32)
    f32 = np.float32
    return (x.astype(np.int8), w0.astype(np.int8), w1.astype(np.int8),
            s0.astype(f32), b0.astype(f32), s1.astype(f32), b1.astype(f32))


@pytest.mark.parametrize("name,band,grid", [
    ("random", None, None),     # the plan's own launch: one step a unit
    ("random", 8, 3),           # two-step units, blocks walk several
    ("extremes", 16, 1),        # one block, whole images
    ("borders", None, None),
    ("ragged", 8, 2),           # H % 4 == 2, three warp tiles a row
])
def test_emulated_body_equals_the_plain_version(name, band, grid):
    """The body emulated over every block of the call equals
    ``stem_conv_int8_reference`` bit for bit and writes every byte of both
    outputs once; the stem rows outside the image are all zero in the
    ring."""
    x, w0, w1, s0, b0, s1, b1 = _k10_case(name)
    N, H, W, _ = x.shape
    plan = k10.stem_conv_plan(N, H, W, 32, 32)
    assert plan.body == "mma"
    if band is not None:
        plan = plan._replace(band=band, grid=grid)
    t = torch.from_numpy
    wk0, wk1 = k12.pack_conv3x3_weights(t(w0)), k12.pack_conv3x3_weights(
        t(w1))
    args = (t(x), wk0, t(s0), t(b0), wk1, t(s1), t(b1))
    want = [a.numpy() for a in k10.stem_conv_int8_reference(*args)]
    watch = []
    got_y, got_p, cy, cyp = _emulate(
        x, k12.pack_stem_mma_weights(t(w0)).numpy(), s0, b0,
        k12.pack_conv3x3_mma_weights(t(w1)).numpy(), s1, b1, plan, watch)
    assert (cy == 1).all() and (cyp == 1).all()
    np.testing.assert_array_equal(got_y, want[0])
    np.testing.assert_array_equal(got_p, want[1])
    assert all(not ring.any() for _, ring in watch)
    rows = {r for r, _ in watch}
    assert -1 in rows and max(rows) >= H
    assert len(np.unique(want[0])) > 3  # not all clipped or zero
    if name == "extremes":  # the clip reached, conv1 beyond 2^22
        mid = k12.conv3x3_int8_reference((t(x),), wk0, t(s0), t(b0))
        assert int(mid[0, 7, 7].min()) == 127
        assert int(want[0].max()) == 127
    if name == "borders":  # the stem of a zero-padded image would differ
        xp = F.pad(t(x).permute(0, 3, 1, 2), (1, 1, 1, 1)).permute(
            0, 2, 3, 1).contiguous()
        mid = k12.conv3x3_int8_reference((xp,), wk0, t(s0), t(b0))
        wrong = k12.conv3x3_int8_reference((mid,), wk1, t(s1), t(b1))
        wrong = wrong[:, 1:-1, 1:-1].numpy()
        assert (wrong[:, 0] != want[0][:, 0]).any()
        assert (wrong[:, :, -1] != want[0][:, :, -1]).any()
        np.testing.assert_array_equal(wrong[:, 1:-1, 1:-1],
                                      want[0][:, 1:-1, 1:-1])


# ----------------------------------------------------------- (d) bank groups


@pytest.mark.parametrize("w", [48, 512])
def test_ring_layout_is_conflict_free(w):
    """The stem's 8-byte stores: each half-warp's 16 stores cover the 32
    banks once (4 pixels x 32 bytes, the units swapped within a pixel);
    conv1's ldmatrix reads of the ring: the 8 rows of every phase fall in
    8 different 16-byte bank groups at every kx and column group, and
    every read stays inside the slot."""
    rp = (w + 2) * CH
    for c in range(w // COLS):
        for h in range(2):
            dst = (_swz(16 * c + _G + 8 * h + 1, _T >> 1) + 8 * (_T & 1))
            assert dst.min() >= 32 and dst.max() + 8 <= rp - 32
            for half in (slice(0, 16), slice(16, 32)):
                banks = ((dst[half, None] + np.arange(0, 8, 4)) // 4) % 32
                assert sorted(banks.ravel().tolist()) == list(range(32))
    a_col, _ = _lane_offsets(4)
    for c in range(w // COLS):
        for kx in range(3):
            addr = c * COLS * CH + a_col[kx]
            assert addr.min() >= 0 and addr.max() + 16 <= rp
            for phase in range(4):
                groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                assert len(set(groups.tolist())) == 8


def test_stem_image_reads_are_conflict_free_at_the_served_width():
    """At 512 columns the stem's 32-bit reads of the image rows (rows t,
    t = 3 reading row 2) put no two different words in one bank: lanes
    that share a bank read the same word (a broadcast)."""
    ip = 512 + 2 * PAD
    word = (PAD - 1 + _G) >> 2
    for c in (0, 17, 31):
        for kk in range(4):
            w_at = (np.minimum(_T, 2) * ip) // 4 + word + 4 * c + kk
            by_bank = {}
            for a in w_at.tolist():
                by_bank.setdefault(a % 32, set()).add(a)
            assert all(len(s) == 1 for s in by_bank.values())
