"""K1's tensor-core body (``csrc/conv3x3_int8.cu:conv3x3_int8_mma``) on the
CPU: its weight pack, ``conv3x3_plan``, the serving qparams that carry its
weights, the ldmatrix swizzle at its halo, and one block emulated byte for
byte in numpy (the loader with its pad fill, every lane's ldmatrix reads,
the m16n8k32 s8 fragment maps, the requant, the pool from the float values
by a register max and a lane^4 exchange, the head) against
``conv3x3_int8_reference``, the version the kernel is held to on the card.
"""

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
    build_model,
    build_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
    quantize_unet_psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_int8 as k12,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.head_argmax import (
    pack_head_weights,
)

ZP7_RESCALE = 14 / 127  # the w4a4 split-scale pool's rescale


def _served_calls(f=32, hw=512, n=32):
    """The 17 non-stem K1 calls of the served U-Net forward: (name, N, H,
    cins, cout, pool), as chip_smoke.stages lists them."""
    out = [("blk0_conv1", n, hw, (f,), f, True)]
    h, c = hw // 2, f
    for i in range(1, 4):
        out += [(f"blk{i}_conv0", n, h, (c,), 2 * c, False),
                (f"blk{i}_conv1", n, h, (2 * c,), 2 * c, True)]
        h, c = h // 2, 2 * c
    out += [("blk4_conv0", n, h, (c,), 2 * c, False),
            ("blk4_conv1", n, h, (2 * c,), 2 * c, False)]
    c *= 2
    for blk in (5, 6, 7, 8):
        h, c = 2 * h, c // 2
        out += [(f"blk{blk}_conv0", n, h, (c, c), c, False),
                (f"blk{blk}_conv1", n, h, (c,), c, False)]
    return out


SERVED = _served_calls()


# ---------------------------------------------------------------- (a) pack


@pytest.mark.parametrize("cins", [(32,), (64,), (128, 128)])
@pytest.mark.parametrize("cout", [32, 64, 512])
def test_pack_conv3x3_mma_weights(cins, cout):
    """(nk, 9, cout, 32), byte [j, t, co, b] = w[co, 32j + b, t // 3, t %
    3] (x0's chunks before x1's); the unpack inverts it, and the one-copy
    conversion from the dp4a body's words gives the same bytes."""
    cin = sum(cins)
    rng = np.random.default_rng(cin + cout)
    w = torch.tensor(rng.integers(-127, 128, (cout, cin, 3, 3)),
                     dtype=torch.int8)
    wm = k12.pack_conv3x3_mma_weights(w)
    assert wm.shape == (cin // 32, 9, cout, 32) and wm.is_contiguous()
    assert torch.equal(k12.unpack_conv3x3_mma_weights(wm, cin, cout), w)
    assert torch.equal(k12.mma_weights_from_dp4a(k12.pack_conv3x3_weights(w)),
                       wm)
    for j, t, co, b in [(0, 0, 0, 0), (cin // 32 - 1, 8, cout - 1, 31),
                        (cin // 64, 4, cout // 2, 17)]:
        assert wm[j, t, co, b] == w[co, 32 * j + b, t // 3, t % 3]


def test_pack_pads_odd_counts_with_zeros():
    """cin and cout that are not multiples of 32 pad with zero bytes."""
    w = torch.ones((40, 36, 3, 3), dtype=torch.int8)
    wm = k12.pack_conv3x3_mma_weights(w)
    assert wm.shape == (2, 9, 64, 32)
    assert int(wm.sum()) == 40 * 36 * 9
    assert torch.equal(k12.unpack_conv3x3_mma_weights(wm, 36, 40), w)


# ------------------------------------------------------- (b) the qparams


@pytest.fixture(scope="module")
def served_qparams():
    """The port's own int8 and w4a4 serving qparams of a small U-Net (f=8,
    32x32 calibration), on the CPU."""
    model = build_model(num_classes=5, init_features=8, seed=0,
                        device="cpu")
    _, calib = build_psrp_forward(model, image_size=32, device="cpu")
    w4a4 = quantize_unet_psrp(calib["layers"], calib["taps"], 8,
                              deep_int4=True, device="cpu")
    return {"int8": calib["qparams"], "w4a4": w4a4}


@pytest.mark.parametrize("mode", ["int8", "w4a4"])
def test_attach_gives_mma_weights(served_qparams, mode):
    """Every 3x3 conv but the stem carries ``w_m``, the tensor-core pack of
    its ``w_q``; ``w_k`` stays the dp4a body's pack; the stem's ``w_m`` is
    the stem body's pack."""
    qp = served_qparams[mode]
    convs = [k for k in qp if k.startswith("blk")]
    assert len(convs) == 18
    for name in convs:
        lw = qp[name]
        assert torch.equal(lw["w_k"], k12.pack_conv3x3_weights(lw["w_q"]))
        if name == "blk0_conv0":
            assert torch.equal(lw["w_m"],
                               k12.pack_stem_mma_weights(lw["w_q"]))
            continue
        assert torch.equal(lw["w_m"],
                           k12.pack_conv3x3_mma_weights(lw["w_q"])), name
    if mode == "w4a4":  # 4-bit weights at the deep stages
        assert int(qp["blk3_conv0"]["w_m"].abs().max()) <= 7


# ---------------------------------------------------------------- (c) plan


@pytest.mark.parametrize("name,n,h,cins,cout,pool", SERVED,
                         ids=[c[0] for c in SERVED])
def test_plan_admits_the_served_calls(name, n, h, cins, cout, pool):
    """All 17 non-stem calls of the served forward at batch 32 go to the
    mma.sync body; two blocks an SM at 32 channels a block, and the
    resident blocks' shared memory within an H100 SM's 228 KB."""
    plan = k12.conv3x3_plan(n, h, h, cins, cout)
    assert plan.body == "mma" and plan.nk == sum(cins) // 32
    assert plan.co_t in (32, 64) and cout % plan.co_t == 0
    assert plan.warps == (4 if plan.nk == 1 else 8)
    assert plan.stages == (3 if plan.nk >= 2 and plan.warps == 8 else 2)
    assert plan.blocks_per_sm == {4: 4, 8: 2 if plan.co_t == 32 else 1}[
        plan.warps]
    assert plan.smem == k12.mma_smem(plan.co_t, plan.stages, plan.warps)
    assert plan.blocks_per_sm * (plan.smem + k12.BLOCK_SMEM_RESERVED) \
        <= k12.SM_SMEM
    if h >= 256 and plan.nk <= 2:  # the short-K stages: 2-4 blocks an SM
        assert plan.co_t == 32 and plan.blocks_per_sm >= 2


def test_plan_admits_the_fused_head():
    """blk8_conv1 ending in the head: 32 channels, one channel tile."""
    plan = k12.conv3x3_plan(32, 512, 512, (32,), 32, True)
    assert (plan.body, plan.co_t, plan.n_co, plan.head) == ("mma", 32, 1,
                                                           True)


@pytest.mark.parametrize("cins,cout,head,aligned", [
    ((2,), 32, False, True),     # two channels (the stem: its own body)
    ((4,), 32, False, True),
    ((5,), 3, False, True),      # odd channel counts
    ((8, 8), 40, False, True),
    ((5, 3), 8, False, True),
    ((16,), 16, False, True),
    ((8,), 8, False, True),
    ((32, 16), 32, False, True),  # one input not a whole chunk
    ((32,), 40, False, True),    # cout not a multiple of 32
    ((32,), 32, False, False),   # a misaligned input
    ((32,), 64, True, True),     # a head over two channel tiles
])
def test_plan_keeps_the_rest_on_dp4a(cins, cout, head, aligned):
    plan = k12.conv3x3_plan(2, 16, 16, cins, cout, head, aligned)
    assert plan.body == "dp4a"


@pytest.mark.parametrize("n,h,w,cins,cout,co_t,warps", [
    (2, 64, 512, (32,), 32, 32, 4), (2, 64, 512, (32,), 32, 32, 8),
    (2, 34, 48, (64, 64), 128, 32, 8), (2, 34, 48, (64, 64), 128, 64, 8),
    (1, 33, 47, (32,), 64, 32, 4), (1, 33, 47, (32,), 64, 64, 8),
    (3, 64, 64, (256,), 256, 64, 8), (1, 8, 8, (512,), 512, 64, 8),
])
def test_plan_tiles_cover_the_output(n, h, w, cins, cout, co_t, warps):
    """The grid's units (tile x channel tile x image) cover every output
    element once, every tile starts on an even row and column (so a 2x2
    window never straddles two tiles), and the shared memory of the
    resident blocks fits an SM."""
    plan = k12.plan_for(n, h, w, cins, cout, False, co_t, warps)
    rows = plan.rows
    assert rows == 4 * warps
    assert plan.tiles_y * rows >= h > (plan.tiles_y - 1) * rows
    assert plan.tiles_x * k12.COLS >= w > (plan.tiles_x - 1) * k12.COLS
    assert plan.blocks_per_sm * (plan.smem + k12.BLOCK_SMEM_RESERVED) \
        <= k12.SM_SMEM
    seen = np.zeros((n, plan.tiles_y * rows, plan.tiles_x * k12.COLS,
                     cout), np.int32)
    for u in range(plan.units):
        rest, c = divmod(u, plan.n_co)
        rest, tx = divmod(rest, plan.tiles_x)
        b, ty = divmod(rest, plan.tiles_y)
        y0, x0 = ty * rows, tx * k12.COLS
        assert y0 % 2 == 0 and x0 % 2 == 0
        seen[b, y0:y0 + rows, x0:x0 + k12.COLS,
             c * co_t:(c + 1) * co_t] += 1
    assert (seen == 1).all()


def test_mma_binding_matches_the_c_entry_point():
    """The ctypes argument list of K1's mma.sync entry point has one entry
    per parameter of the C function, pointers where it takes pointers,
    floats where it takes floats."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    src = (_build.CSRC / "conv3x3_int8.cu").read_text()
    params = re.search(r'extern "C" int octseg_conv3x3_int8_mma\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_conv3x3_int8_mma"]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
        assert ("float" in p) == (t is ctypes.c_float), (p, t)


# ----------------------------------------------------------- (d) swizzle
# The kernel's addressing (csrc/conv3x3_int8.cu: swz, lane_offsets,
# mma_chunk, the loader and the epilogue), written out in numpy.
_LANES = np.arange(32)
_G, _T = _LANES // 4, _LANES % 4
_HALO_W, _KCH = k12.COLS + 2, k12.KCHUNK
_PITCH = (k12.COLS + 2) * k12.KCHUNK


def _halo(warps):
    """(halo rows, bytes of one chunk's halo) of a block of ``warps``."""
    return k12.MW * warps + 2, (k12.MW * warps + 2) * _PITCH


def _swz(p, u):
    """Byte offset of 16-byte unit u of 32-byte row p."""
    return ((2 * p + u) ^ ((p >> 2) & 1)) * 16


def _lane_offsets(nt):
    a_col = [_swz(kx + (_LANES & 7) + 8 * ((_LANES >> 3) & 1), _LANES >> 4)
             for kx in range(3)]
    b_off = [_swz(16 * j + (_LANES & 7) + 8 * (_LANES >> 4),
                  (_LANES >> 3) & 1) for j in range(nt // 2)]
    return a_col, b_off


@pytest.mark.parametrize("co_t,warps", [(32, 8), (64, 8), (32, 4)])
def test_k1_swizzle_keeps_ldmatrix_conflict_free(co_t, warps):
    """At K1's halos (34 or 18 rows of 18 pixels, 32 bytes a pixel) the 8
    rows of every ldmatrix phase fall in 8 different bank groups: for
    every tap, tile row and 16-pixel half of the A reads, and for every
    tap and n8 pair of the B reads at both channel widths a block; the
    swizzle is a permutation within each row pair."""
    a_col, b_off = _lane_offsets(co_t // 8)
    _, halo = _halo(warps)
    for ky in range(3):
        for kx in range(3):
            for row in range(k12.MW * warps):
                addr = (row + ky) * _PITCH + a_col[kx]
                assert addr.max() + 16 <= halo
                for phase in range(4):
                    groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                    assert len(set(groups.tolist())) == 8, (ky, kx, row)
    for tap in range(9):
        for off in b_off:
            addr = halo + tap * co_t * _KCH + off
            for phase in range(4):
                groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                assert len(set(groups.tolist())) == 8
    p = np.arange(64)
    for u in (0, 1):
        assert sorted(_swz(p, u) // 16 // 2) == list(range(64))


# ----------------------------------------------------- (e) one emulated block


def _ldmatrix_x4(smem, addr):
    """ldmatrix.x4 (b16, not transposed): lane l gives the address of row
    l % 8 of matrix l // 8; register i of lane l is bytes 4(l % 4)..+3 of
    row l // 4 of matrix i. -> (32 lanes, 4 registers, 4 bytes) int8."""
    rows = np.stack([smem[a:a + 16] for a in addr])
    out = np.empty((32, 4, 4), np.int8)
    for i in range(4):
        out[:, i] = rows[8 * i + _LANES // 4].reshape(32, 4, 4)[
            _LANES, _LANES % 4].view(np.int8)
    return out


def _a_matrix(a):
    """m16n8k32 s8 A fragments -> the 16 x 32 tile (g = lane / 4, t = lane
    % 4): a0 (g, 4t..4t+3), a1 (g+8, 4t..), a2 (g, 16+4t..), a3 (g+8,
    16+4t..)."""
    A = np.zeros((16, 32), np.int64)
    for i in range(4):
        A[_G, 4 * _T + i] = a[:, 0, i]
        A[_G + 8, 4 * _T + i] = a[:, 1, i]
        A[_G, 16 + 4 * _T + i] = a[:, 2, i]
        A[_G + 8, 16 + 4 * _T + i] = a[:, 3, i]
    return A


def _b_matrix(b0, b1):
    """B fragments -> the 32 x 8 tile: b0 (k 4t..4t+3, column g), b1 (k
    16+4t.., g)."""
    B = np.zeros((32, 8), np.int64)
    for i in range(4):
        B[4 * _T + i, _G] = b0[:, i]
        B[16 + 4 * _T + i, _G] = b1[:, i]
    return B


def _mma(acc, A, B):
    """acc (32 lanes, c0..c3) += A @ B by the C map: c0, c1 (g, 2t, 2t+1),
    c2, c3 (g+8, 2t, 2t+1)."""
    D = A @ B
    acc[:, 0] += D[_G, 2 * _T]
    acc[:, 1] += D[_G, 2 * _T + 1]
    acc[:, 2] += D[_G + 8, 2 * _T]
    acc[:, 3] += D[_G + 8, 2 * _T + 1]


def _fma(a, b, c):
    """float32 fmaf, as ``fma_reference``."""
    return (np.float64(np.float32(a)) * np.float64(b)
            + np.float64(c)).astype(np.float32)


def _rounded_byte(v, lo, hi):
    """The kernel's ``rounded_bits``: clip to [lo, hi], add 1.5 * 2^23 in
    float32, the low byte of the sum's bits (as int8 bits)."""
    t = np.minimum(np.maximum(np.float32(v), np.float32(lo)), np.float32(hi))
    s = (t + np.float32(12582912.0)).astype(np.float32)
    return (s.view(np.uint32) & 0xFF).astype(np.uint8)


@pytest.mark.parametrize("clip", [127.0, 7.0])
def test_rounding_by_add_equals_rint_then_clip(clip):
    """``rounded_bits`` equals round-half-even then the clip for every
    float32 within 4 ulps of each half-integer and integer in [-140,
    140], at +-clip and with relu's lower bound 0."""
    grid = np.float32(np.arange(-280, 281) / 2)
    v = [grid, np.float32([0.0, -0.0, 1e9, -1e9])]
    for way in (np.inf, -np.inf):
        near = grid
        for _ in range(4):
            near = np.nextafter(near, np.float32(way))
            v.append(near)
    v = np.concatenate(v)
    for lo in (-clip, 0.0):
        want = np.clip(np.rint(v), lo, clip).astype(np.int8).view(np.uint8)
        np.testing.assert_array_equal(_rounded_byte(v, lo, clip), want)


def _emulate_block(xs, pads, wm, scale, bias, plan, n, ty, tx, cb, out, *,
                   relu=True, out_clip=127.0, pool_rescale=1.0,
                   pool_shift=0.0, pool_clip=None, head=None):
    """The block (n, tile (ty, tx), channel tile cb) of conv3x3_int8_mma:
    the loader's swizzled halo copies (the pad value of the chunk's input
    outside the image) and weight copies into ring slot j % stages, every
    warp's ldmatrix reads and m16n8k32 products per chunk and tap, the
    epilogue's int8 tile, the pool from the float values (rows m, m+1 of
    a thread, lanes l and l^4), the head, and the 16-byte stores into
    ``out`` ({"y", "yp"} or {"labels"}: numpy arrays)."""
    H, W = plan.H, plan.W
    nt, co_t = plan.co_t // 8, plan.co_t
    rows, (hr_n, halo) = plan.rows, _halo(plan.warps)
    ty0, tx0, co0 = ty * rows, tx * k12.COLS, cb * co_t
    cin0, cout = xs[0].shape[-1], plan.cout
    smem = np.zeros(plan.smem, np.uint8)
    stage = halo + 9 * co_t * _KCH
    a_col, b_off = _lane_offsets(nt)
    acc = np.zeros((8, 4, nt, 32, 4), np.int64)  # warp, m, n8, lane, c
    for j in range(plan.nk):
        off = (j % plan.stages) * stage
        k = 0 if j * 32 < cin0 else 1
        x, c0 = xs[k], j * 32 - k * cin0
        fill = np.full(16, pads[k], np.int8).view(np.uint8)
        for e in range(hr_n * _HALO_W * 2):
            u, p = e & 1, e >> 1
            hr, hc = divmod(p, _HALO_W)
            iy, ix = ty0 - 1 + hr, tx0 - 1 + hc
            dst = off + hr * _PITCH + _swz(hc, u)
            smem[dst:dst + 16] = (
                x[n, iy, ix, c0 + 16 * u:c0 + 16 * u + 16].view(np.uint8)
                if 0 <= iy < H and 0 <= ix < W else fill)
        for e in range(9 * co_t * 2):
            u, r = e & 1, e >> 1
            tap, co = divmod(r, co_t)
            dst = off + halo + tap * co_t * _KCH + _swz(co, u)
            smem[dst:dst + 16] = wm[j, tap, co0 + co, 16 * u:16 * u + 16] \
                .view(np.uint8)
        for warp in range(plan.warps):  # mma_chunk: per kx, the taps' B, then
            a_rows = off + warp * 4 * _PITCH  # each halo row r once
            for kx in range(3):
                B = []
                for ky in range(3):
                    bt = off + halo + (ky * 3 + kx) * nt * 8 * _KCH
                    B.append([])
                    for jj in range(nt // 2):
                        r = _ldmatrix_x4(smem, bt + b_off[jj])
                        B[ky] += [_b_matrix(r[:, 0], r[:, 1]),
                                  _b_matrix(r[:, 2], r[:, 3])]
                for row in range(4 + 2):
                    A = _a_matrix(_ldmatrix_x4(
                        smem, a_rows + row * _PITCH + a_col[kx]))
                    for ky in range(3):
                        if 0 <= row - ky < 4:
                            for t in range(nt):
                                _mma(acc[warp, row - ky, t], A, B[ky][t])
    # the epilogue: the int8 tile, the pooled tile after it
    op = co_t + 16
    os_ = np.zeros(rows * k12.COLS * op, np.uint8)
    ps = np.zeros(rows * k12.COLS // 4 * op, np.uint8)
    pool = "yp" in out
    clip_p = out_clip if pool_clip is None else pool_clip
    for warp in range(plan.warps):
        for t in range(nt):
            c = 8 * t + 2 * (_LANES & 3)
            v = np.zeros((4, 2, 2, 32), np.float32)  # m, h, e, lane
            for m in range(4):
                for h in range(2):
                    for e in range(2):
                        co = co0 + c + e
                        val = _fma(acc[warp, m, t, :, 2 * h + e], scale[co],
                                   bias[co])
                        v[m, h, e] = np.maximum(val, 0) if relu else val
                    px = (warp * 4 + m) * k12.COLS + (_LANES >> 2) + 8 * h
                    for e in range(2):
                        os_[px * op + c + e] = _rounded_byte(
                            v[m, h, e], 0.0 if relu else -out_clip, out_clip)
            if not pool:
                continue
            for m in (0, 2):
                for h in range(2):
                    for e in range(2):
                        mx = np.maximum(v[m, h, e], v[m + 1, h, e])
                        mx = np.maximum(mx, mx[_LANES ^ 4])  # the shuffle
                        q = _rounded_byte(_fma(mx, pool_rescale,
                                               pool_shift), -clip_p, clip_p)
                        own = (_LANES & 4) == 0
                        pp = ((warp * 4 + m) // 2) * (k12.COLS // 2) \
                            + (_LANES >> 3) + 4 * h
                        ps[(pp * op + c + e)[own]] = q[own]
    if head is not None:
        hw, hs, hb = head
        for p in range(rows * k12.COLS):
            oy, ox = ty0 + p // k12.COLS, tx0 + p % k12.COLS
            if oy >= H or ox >= W:
                continue
            t8 = os_[p * op:p * op + co_t].view(np.int8).astype(np.int64)
            best, arg = 0.0, 0
            for k in range(hw.shape[0]):
                a = int(t8 @ hw[k].astype(np.int64))  # dp4a over the words
                z = _fma(np.float32(a), hs[k], hb[k])
                if k == 0 or z > best:
                    best, arg = z, k
            out["labels"][n, oy, ox] = arg
        return
    upp = co_t // 16
    for e in range(rows * k12.COLS * upp):
        px, u = divmod(e, upp)
        oy, ox = ty0 + px // k12.COLS, tx0 + px % k12.COLS
        if oy < H and ox < W:
            out["y"][n, oy, ox, co0 + 16 * u:co0 + 16 * u + 16] = \
                os_[px * op + 16 * u:px * op + 16 * u + 16].view(np.int8)
    if pool:
        for e in range(rows * k12.COLS // 4 * upp):
            pp, u = divmod(e, upp)
            oy = ty0 // 2 + pp // (k12.COLS // 2)
            ox = tx0 // 2 + pp % (k12.COLS // 2)
            if oy < H // 2 and ox < W // 2:
                out["yp"][n, oy, ox, co0 + 16 * u:co0 + 16 * u + 16] = \
                    ps[pp * op + 16 * u:pp * op + 16 * u + 16].view(np.int8)


def _crafted_pool_case():
    """tests/test_torch_int4.py's ``fma_ties`` values: an all-zero input
    and scale 1, so every output is its channel's bias, chosen within two
    float32 ulps of m where fmaf(m, 14/127, -7) = k + 0.5; an FMA and a
    product rounded before the sum disagree on some of them. Here 32
    input channels and the 70 biases plus 26 repeated (96 outputs)."""
    r = np.float64(np.float32(ZP7_RESCALE))
    bias = []
    for k in range(-7, 7):
        m = np.float32((k + 7.5) / r)
        for d in (-2, -1, 0, 1, 2):
            v = m
            for _ in range(abs(d)):
                v = np.nextafter(v, np.float32(np.inf if d > 0 else -np.inf))
            bias.append(v)
    bias = np.asarray(bias + bias[:26], np.float32)
    rng = np.random.default_rng(7)
    x = np.zeros((1, 32, 16, 32), np.int8)
    w = rng.integers(-20, 20, (bias.size, 32, 3, 3)).astype(np.int8)
    return x, w, np.ones(bias.size, np.float32), bias


def _case(name):
    """(xs, pads, w (cout, cin, 3, 3), scale, bias, knobs, the corner of
    the image whose tile is emulated, head) of one emulated case, numpy."""
    rng = np.random.default_rng(len(name))
    head = None
    if name == "fma_ties":
        x, w, scale, bias = _crafted_pool_case()
        knobs = dict(pool=True, pool_rescale=ZP7_RESCALE, pool_shift=-7.0,
                     pool_clip=7.0)
        return (x,), (0,), w, scale, bias, knobs, "top-left", None
    if name == "pool":  # the default knobs, two chunks, the top-left tile
        xs = (rng.integers(0, 128, (1, 48, 32, 64)).astype(np.int8),)
        pads, cout, knobs, tile = (0,), 64, dict(pool=True), "top-left"
    elif name == "pads":  # (0, -7): two inputs, the bottom-right tile
        xs = (rng.integers(0, 128, (1, 34, 48, 32)).astype(np.int8),
              rng.integers(-7, 8, (1, 34, 48, 32)).astype(np.int8))
        pads, cout, tile = (0, -7), 64, "bottom-right"
        knobs = dict(pad_vals=(0, -7), relu=False, out_clip=7.0)
    else:  # the head at the bottom-left corner of a partial tile
        xs = (rng.integers(0, 128, (1, 40, 32, 32)).astype(np.int8),)
        pads, cout, knobs, tile = (0,), 32, {}, "bottom-left"
        nc = 10
        head = (rng.integers(-40, 40, (nc, cout)).astype(np.int8),
                rng.uniform(1e-3, 2e-3, nc).astype(np.float32),
                rng.uniform(-1, 1, nc).astype(np.float32))
    cin = sum(x.shape[-1] for x in xs)
    w = rng.integers(-40, 40, (cout, cin, 3, 3)).astype(np.int8)
    std = (9 * cin) ** 0.5 * 23 * (4 if name == "pads" else 37)
    scale = (rng.uniform(30, 60, cout) / std).astype(np.float32)
    bias = rng.uniform(-5, 5, cout).astype(np.float32)
    return xs, pads, w, scale, bias, knobs, tile, head


@pytest.mark.parametrize("name,co_t,warps", [
    ("pool", 32, 8), ("pool", 64, 8), ("pool", 32, 4), ("pads", 32, 8),
    ("pads", 64, 8), ("pads", 32, 4), ("fma_ties", 32, 8),
    ("fma_ties", 32, 4), ("head", 32, 8), ("head", 32, 4)])
def test_emulated_mma_block_equals_the_plain_version(name, co_t, warps):
    """One mma.sync block emulated byte for byte equals
    ``conv3x3_int8_reference`` exactly on its tile (32 x 16 of 8 warps,
    16 x 16 of 4) at an image corner: the default knobs with a pool (two
    K chunks, the ring slots in turn), ``pad_vals=(0, -7)`` over two
    inputs (the pad fill, a partial tile), the split-scale pool on the
    ``fma_ties`` values, and the head (a partial tile)."""
    xs, pads, w, scale, bias, knobs, corner, head = _case(name)
    cout = w.shape[0]
    N, H, W, _ = xs[0].shape
    tw = torch.from_numpy(w)
    wk, wm = k12.pack_conv3x3_weights(tw), k12.pack_conv3x3_mma_weights(tw)
    cins = tuple(x.shape[-1] for x in xs)
    plan = k12.plan_for(N, H, W, cins, cout, head is not None, co_t, warps)
    ty = plan.tiles_y - 1 if corner.startswith("bottom") else 0
    tx = plan.tiles_x - 1 if corner.endswith("right") else 0
    args = (tuple(torch.from_numpy(x) for x in xs), wk,
            torch.from_numpy(scale), torch.from_numpy(bias))
    th = None if head is None else (
        pack_head_weights(torch.from_numpy(head[0]).reshape(
            head[0].shape + (1, 1))),
        torch.from_numpy(head[1]), torch.from_numpy(head[2]))
    want = k12.conv3x3_int8_reference(*args, head=th, **knobs)
    want = tuple(t.numpy() for t in (want if knobs.get("pool")
                                     else (want,)))
    out = ({"labels": np.full((N, H, W), -1, np.int8)} if head is not None
           else {"y": np.zeros((N, H, W, cout), np.int8)})
    if knobs.get("pool"):
        out["yp"] = np.zeros((N, H // 2, W // 2, cout), np.int8)
    emu = {k: v for k, v in knobs.items() if k not in ("pool", "pad_vals")}
    for cb in range(cout // co_t):
        _emulate_block(xs, pads, wm.numpy(), scale, bias, plan, 0, ty, tx,
                       cb, out, head=head, **emu)
    r0, c0 = ty * plan.rows, tx * k12.COLS
    region = (0, slice(r0, r0 + plan.rows), slice(c0, c0 + k12.COLS))
    got = out["labels"] if head is not None else out["y"]
    np.testing.assert_array_equal(got[region], want[0][region])
    if head is None:
        assert len(np.unique(want[0][region])) > 3  # not all clipped
    if knobs.get("pool"):
        pregion = (0, slice(r0 // 2, (r0 + plan.rows) // 2),
                   slice(c0 // 2, (c0 + k12.COLS) // 2))
        np.testing.assert_array_equal(out["yp"][pregion], want[1][pregion])
    if name == "fma_ties":  # the case separates one rounding from two
        m = bias.reshape(1, 1, 1, -1)
        two = np.clip(np.round((m * np.float32(ZP7_RESCALE)).astype(
            np.float32) - np.float32(7)), -7, 7)
        assert (two != want[1]).any()
    if name == "pads":  # a zero fill would give other values at the border
        zero = k12.conv3x3_int8_reference(*args, relu=False, out_clip=7.0)
        assert not np.array_equal(zero.numpy()[region], got[region])
