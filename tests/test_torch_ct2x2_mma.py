"""K2's tensor-core body (``csrc/ct2x2_int8.cu:ct2x2_int8_mma``) on the
CPU: its weight pack, ``ct2x2_plan``, the ctypes binding, the ldmatrix
swizzle and the epilogue's shared-memory tile, the rounding by an add, and
one block emulated byte for byte in numpy (the weight and ring copies with
their zero fill, every lane's ldmatrix reads, the m16n8k32 s8 fragment
maps, the requant into the output tile, the 16-byte or byte stores)
against ``ct2x2_int8_reference``, the version the kernel is held to on the
card.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    _build,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_int8 as k12,
)
from test_torch_conv3x3_mma import (
    _LANES,
    _a_matrix,
    _b_matrix,
    _fma,
    _ldmatrix_x4,
    _mma,
    _rounded_byte,
    _swz,
)

_KCH = k12.KCHUNK
_STAGES = k12.CT_STAGES


def _ct_calls(f, hw=512, n=32):
    """The served forward's four K2 calls at width f: (name, N, H, cin,
    cout), as chip_smoke.stages lists them."""
    h, c = hw // 16, 16 * f
    out = []
    for k in range(4):
        out.append((f"ct{k}", n, h, c, c // 2))
        h, c = 2 * h, c // 2
    return out


SERVED = [(f,) + c for f in (16, 32) for c in _ct_calls(f)]
# the shapes of tests/test_torch_cuda.py's K2 tests
CUDA_SHAPES = [(2, 4, 4, 16, 8), (1, 3, 5, 12, 5), (2, 8, 8, 64, 32),
               (2, 8, 8, 128, 64), (2, 32, 32, 512, 256),
               (2, 5, 7, 96, 40)]


# ---------------------------------------------------------------- (a) pack


@pytest.mark.parametrize("cin,cout", sorted(
    {(c[3], c[4]) for c in SERVED}
    | {(128, 64), (64, 32), (32, 16), (16, 8), (12, 5), (48, 40)}))
def test_pack_ct2x2_weights(cin, cout):
    """(nk, 4*cout, 32), byte [j, col, b] = w[32j + b, co, dy, dx] for
    column (2dy + dx)*cout + co, cin zero-padded to nk*32; the unpack
    inverts it."""
    rng = np.random.default_rng(cin + cout)
    w = torch.tensor(rng.integers(-127, 128, (cin, cout, 2, 2)),
                     dtype=torch.int8)
    wp = k12.pack_ct2x2_weights(w)
    nk = -(-cin // 32)
    assert wp.shape == (nk, 4 * cout, 32) and wp.is_contiguous()
    assert torch.equal(k12.unpack_ct2x2_weights(wp, cin), w)
    for c, co, dy, dx in [(0, 0, 0, 0), (cin - 1, cout - 1, 1, 1),
                          (cin // 2, cout // 3, 1, 0), (cin // 3, 0, 0, 1)]:
        assert wp[c // 32, (2 * dy + dx) * cout + co, c % 32] == \
            w[c, co, dy, dx]
    assert int(wp.reshape(nk * 4 * cout, 32)[:, :].abs().sum()) == \
        int(w.abs().sum())  # the padding is zeros


# ---------------------------------------------------------------- (b) plan


def _check_cover(plan):
    """The grid's blocks (x, channel tile) walk the tiles x, x + grid, ...:
    every tile of every channel tile is met once, and the tiles and the
    channel tiles cover the pixels and the channels exactly."""
    M = plan.N * plan.H * plan.W
    seen = np.zeros((plan.units, plan.n_co), np.int32)
    for bx in range(plan.grid):
        seen[bx::plan.grid] += 1
    assert (seen == 1).all()
    assert plan.units * plan.tm >= M > (plan.units - 1) * plan.tm
    assert plan.n_co * plan.co_t >= plan.cout > (plan.n_co - 1) * plan.co_t


@pytest.mark.parametrize("f,name,n,h,cin,cout", SERVED,
                         ids=[f"f{c[0]}_{c[1]}" for c in SERVED])
def test_plan_admits_the_served_calls(f, name, n, h, cin, cout):
    """Every K2 call of the served forward at f = 16 and 32 (batch 32):
    cp.async loads, two blocks an SM within an H100 SM's shared memory, a
    persistent grid of at most two blocks an SM, and tiles that cover
    every output pixel and channel once; at f = 32, one channel tile a
    block where the weights allow (ct2, ct3: 16-byte runs of whole output
    rows)."""
    plan = k12.ct2x2_plan(n, h, h, cin, cout)
    assert plan.tm * plan.co_t == 32 * 128 and plan.warps == 8
    assert plan.loader == "async" and plan.nk == cin // 32
    assert plan.stages == k12.CT_STAGES
    assert plan.smem == k12.ct2x2_smem(plan.tm, plan.co_t, plan.nk)
    assert plan.smem <= 232448
    assert plan.blocks_per_sm == 2
    assert 2 * (plan.smem + k12.BLOCK_SMEM_RESERVED) <= k12.SM_SMEM
    assert plan.grid * plan.n_co <= 2 * k12.H100_SMS
    if f == 32:
        assert (plan.tm, plan.co_t) == {"ct0": (128, 32), "ct1": (64, 64),
                                        "ct2": (64, 64),
                                        "ct3": (128, 32)}[name]
    _check_cover(plan)


@pytest.mark.parametrize("n,h,w,cin,cout", CUDA_SHAPES)
def test_plan_covers_the_cuda_test_shapes(n, h, w, cin, cout):
    """The CUDA tests' shapes: admitted, the loader by cin % 16 and the
    input's alignment, tiles covering the output once."""
    for aligned in (True, False):
        plan = k12.ct2x2_plan(n, h, w, cin, cout, aligned)
        assert plan.tm > 0
        assert plan.loader == ("async" if cin % 16 == 0 and aligned
                               else "gather")
        assert plan.co_t <= max(16, -(-cout // 16) * 16)
        _check_cover(plan)
        one = k12.ct2x2_plan_for(n, h, w, cin, cout, plan.co_t, aligned,
                                 persistent=False)
        assert one.grid == one.units
        _check_cover(one)


def test_plan_refuses_weights_beyond_shared_memory():
    """cin so deep that even 16 channels' weights (cin x 64 bytes) leave
    no room for the ring and the tile: refused (tm = 0), so the wrapper
    raises."""
    plan = k12.ct2x2_plan(1, 2, 2, 4096, 8)
    assert plan.tm == 0 and plan.smem > 232448
    assert k12.ct2x2_plan(1, 2, 2, 2048, 8).tm > 0


def test_binding_matches_the_c_entry_point():
    """The ctypes argument list of K2's entry point has one entry per
    parameter of the C function, pointers where it takes pointers, floats
    where it takes floats."""
    src = (_build.CSRC / "ct2x2_int8.cu").read_text()
    params = re.search(r'extern "C" int octseg_ct2x2_int8\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_ct2x2_int8"]
    assert len(params) == len(argtypes) == 20
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
        assert ("float" in p) == (t is ctypes.c_float), (p, t)


def test_library_hash_reads_the_shared_header(tmp_path, monkeypatch):
    """K1, K2 and K7 include csrc/mma_int8.cuh, and an edit of it names
    another library, so it rebuilds (on a copy of csrc/)."""
    for cu in ("conv3x3_int8.cu", "conv7x3_int8.cu", "ct2x2_int8.cu"):
        assert '#include "mma_int8.cuh"' in (_build.CSRC / cu).read_text()
    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    hashed = _build.library_path()
    header = tmp_path / "mma_int8.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    assert _build.library_path() != hashed
    assert [s.name for s in _build._sources()] == sorted(
        s.name for s in tmp_path.glob("*.cu"))


# ---------------------------------------------------- (c) shared memory
# The kernel's addressing (csrc/ct2x2_int8.cu: the lane offsets, the
# copies, mma_chunk and the epilogue), written out in numpy.


def _layout(plan):
    """(WM, WN, N columns a block, ring offset, output tile offset, output
    tile row bytes, (scale, bias) offset) of a plan."""
    wn = plan.co_t // 16
    nb = 4 * plan.co_t
    ring = plan.nk * nb * _KCH
    os_off, orow = ring + _STAGES * plan.tm * _KCH, 2 * plan.co_t + 16
    return 8 // wn, wn, nb, ring, os_off, orow, os_off + 2 * plan.tm * orow


def _lane_offsets(wm, wn):
    """The addresses of each ldmatrix of warp (wm, wn) (32 lanes): A of m16
    tile m at a_off + 16 rows * m, B of n8 pair j at b_off + 16 rows * j;
    the swizzle keeps bit 2 of a row under a shift by 16 rows, so these
    are the rows' own swizzled offsets."""
    a_off = _swz(wm * 32 + (_LANES & 7) + 8 * ((_LANES >> 3) & 1),
                 _LANES >> 4)
    b_off = _swz(wn * 64 + (_LANES & 7) + 8 * (_LANES >> 4),
                 (_LANES >> 3) & 1)
    a = [a_off + m * 16 * _KCH for m in range(2)]
    b = [b_off + j * 16 * _KCH for j in range(4)]
    assert all((x == _swz(wm * 32 + 16 * m + (_LANES & 7)
                          + 8 * ((_LANES >> 3) & 1), _LANES >> 4)).all()
               for m, x in enumerate(a))
    assert all((x == _swz(wn * 64 + 16 * j + (_LANES & 7)
                          + 8 * (_LANES >> 4), (_LANES >> 3) & 1)).all()
               for j, x in enumerate(b))
    return a, b


@pytest.mark.parametrize("tm,co_t", k12.CT_TILES)
def test_swizzle_keeps_ldmatrix_conflict_free(tm, co_t):
    """The 8 rows of every ldmatrix phase fall in 8 different bank groups:
    each warp's A reads (ring slot rows) and B reads (weight rows)."""
    plan = k12.ct2x2_plan_for(1, 8, 32, 64, 4 * co_t, co_t)
    assert plan.tm == tm
    wm_n, wn_n, nb, ring, _, _, _ = _layout(plan)
    for warp in range(8):
        a_off, b_off = _lane_offsets(warp // wn_n, warp % wn_n)
        for addr in a_off:
            assert addr.max() + 16 <= tm * _KCH
        for addr in b_off:
            assert addr.max() + 16 <= nb * _KCH
        for addr in a_off + b_off:
            for phase in range(4):
                groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                assert len(set(groups.tolist())) == 8


@pytest.mark.parametrize("tm,co_t", k12.CT_TILES)
def test_epilogue_tile_stores_are_conflict_free(tm, co_t):
    """Each 2-byte store of the epilogue into the output tile (one n8
    tile, one m16 half) puts its 32 lanes in 32 banks or in a bank's one
    word (rows of 2*co_t + 16 bytes); the tile's 16-byte reads stay inside
    it."""
    plan = k12.ct2x2_plan_for(1, 8, 32, 64, 4 * co_t, co_t)
    wm_n, wn_n, _, _, os_off, orow, sb_off = _layout(plan)
    for warp in range(8):
        wm, wn = warp // wn_n, warp % wn_n
        for t in range(8):
            n = wn * 64 + 8 * t + 2 * (_LANES & 3)
            tap, c = n // co_t, n % co_t
            assert len(set(tap.tolist())) == 1  # an n8 tile is one tap
            for m in range(2):
                for h in range(2):
                    p = wm * 32 + 16 * m + (_LANES >> 2) + 8 * h
                    addr = ((tap >> 1) * tm + p) * orow + (tap & 1) * co_t + c
                    words = addr // 4
                    for bank in range(32):
                        assert len(set(words[words % 32 == bank])) <= 1
    assert sb_off == os_off + 2 * tm * orow
    assert sb_off + 4 * co_t * 8 == plan.smem


@pytest.mark.parametrize("clip", [127.0, 7.0])
def test_rounding_by_add_equals_rint_then_clip(clip):
    """K2's epilogue clips to [-clip, clip] and rounds by adding 1.5 * 2^23
    (``rounded_bits`` in csrc/mma_int8.cuh), equal to round-half-even then
    the clip for every float32 within 4 ulps of each half-integer and
    integer in [-140, 140] and far outside."""
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    assert "__fadd_rn(fminf(fmaxf(v, lo), hi), 12582912.0f)" in header
    assert "rounded_bits(v0, -clip, clip)" in \
        (_build.CSRC / "ct2x2_int8.cu").read_text()
    grid = np.float32(np.arange(-280, 281) / 2)
    v = [grid, np.float32([0.0, -0.0, 1e9, -1e9, 8258048.0])]
    for way in (np.inf, -np.inf):
        near = grid
        for _ in range(4):
            near = np.nextafter(near, np.float32(way))
            v.append(near)
    v = np.concatenate(v)
    want = np.clip(np.rint(v), -clip, clip).astype(np.int8).view(np.uint8)
    np.testing.assert_array_equal(_rounded_byte(v, -clip, clip), want)


# ----------------------------------------------------- (d) one emulated block


def _emulate_block(x, wp, scale, bias, plan, bx, cb, out, count,
                   out_clip=127.0):
    """Block (bx, cb) of ct2x2_int8_mma, all its tiles bx, bx + grid, ...:
    the weight copies (zeros beyond cout), the ring's chunk copies (slot s
    % STAGES across tiles; zeros beyond M and cin), every warp's ldmatrix
    reads and m16n8k32 products, the requant into the output tile and the
    stores into ``out`` (numpy (N, 2H, 2W, cout)); ``count`` counts the
    writes of each output byte."""
    N, H, W, cin = x.shape
    M, cout = N * H * W, plan.cout
    tm, co_t, nk = plan.tm, plan.co_t, plan.nk
    wm_n, wn_n, nb, ring, os_off, orow, sb_off = _layout(plan)
    co0 = cb * co_t
    xf = x.reshape(M, cin).view(np.uint8)
    wu = wp.view(np.uint8)
    smem = np.zeros(plan.smem, np.uint8)
    per_col = bias.size == 4 * cout
    scb = smem[sb_off:].view(np.float32).reshape(nb, 2)
    for n in range(nb):  # the (scale, bias) of each block column
        tap, c = divmod(n, co_t)
        co = co0 + c
        if co < cout:
            scb[n] = scale[co], bias[tap * cout + co] if per_col else bias[co]
    for e in range(nk * nb * 2):
        u, r = e & 1, e >> 1
        j, n = divmod(r, nb)
        tap, c = divmod(n, co_t)
        dst = j * nb * _KCH + _swz(n, u)
        smem[dst:dst + 16] = (wu[j, tap * cout + co0 + c, 16 * u:16 * u + 16]
                              if co0 + c < cout else 0)
    tiles = list(range(bx, plan.units, plan.grid))
    acc = np.zeros((8, 2, 8, 32, 4), np.int64)  # warp, m, n8, lane, c
    for s in range(len(tiles) * nk):
        tile, j = tiles[s // nk], s % nk
        slot = ring + (s % _STAGES) * tm * _KCH
        for e in range(tm * 2):
            u, p = e & 1, e >> 1
            m, c = tile * tm + p, j * _KCH + 16 * u
            unit = np.zeros(16, np.uint8)
            if m < M and c < cin:
                part = xf[m, c:c + 16]
                unit[:part.size] = part
            dst = slot + _swz(p, u)
            smem[dst:dst + 16] = unit
        if j == 0:
            acc[:] = 0
        for warp in range(8):
            wm, wn = warp // wn_n, warp % wn_n
            a_off, b_off = _lane_offsets(wm, wn)
            B = []
            for jj in range(4):
                r = _ldmatrix_x4(smem, j * nb * _KCH + b_off[jj])
                B += [_b_matrix(r[:, 0], r[:, 1]), _b_matrix(r[:, 2], r[:, 3])]
            for mt in range(2):
                A = _a_matrix(_ldmatrix_x4(smem, slot + a_off[mt]))
                for t in range(8):
                    _mma(acc[warp, mt, t], A, B[t])
        if j < nk - 1:
            continue
        # the epilogue: the requant into the output tile ...
        for warp in range(8):
            wm, wn = warp // wn_n, warp % wn_n
            for t in range(8):
                n = wn * 64 + 8 * t + 2 * (_LANES & 3)
                tap, c = n // co_t, n % co_t
                dy, dx = tap >> 1, tap & 1
                sb4 = np.stack([scb[n], scb[n + 1]], 1).reshape(32, 4)
                sb = [(sb4[:, 0], sb4[:, 1]), (sb4[:, 2], sb4[:, 3])]
                for mt in range(2):
                    for h in range(2):
                        p = wm * 32 + 16 * mt + (_LANES >> 2) + 8 * h
                        for e in range(2):
                            v = _fma(acc[warp, mt, t, :, 2 * h + e], *sb[e])
                            smem[os_off + (dy * tm + p) * orow + dx * co_t
                                 + c + e] = _rounded_byte(v, -out_clip,
                                                          out_clip)
        # ... and the stores
        flat, cnt = out.reshape(-1), count.reshape(-1)
        if cout % 16 == 0:
            upt = co_t // 16
            for e in range(2 * tm * 2 * upt):
                dy, rem = divmod(e, tm * 2 * upt)
                p, q = divmod(rem, 2 * upt)
                dx, cu = divmod(q, upt)
                m, c = tile * tm + p, 16 * cu
                if m < M and co0 + c < cout:
                    r, jx = divmod(m, W)
                    o = ((2 * r + dy) * 2 * W + 2 * jx + dx) * cout + co0 + c
                    src = os_off + (dy * tm + p) * orow + 16 * q
                    flat[o:o + 16] = smem[src:src + 16].view(np.int8)
                    cnt[o:o + 16] += 1
        else:
            for e in range(2 * tm * 2 * co_t):
                dy, rem = divmod(e, tm * 2 * co_t)
                p, q = divmod(rem, 2 * co_t)
                dx, c = divmod(q, co_t)
                m = tile * tm + p
                if m < M and co0 + c < cout:
                    r, jx = divmod(m, W)
                    o = ((2 * r + dy) * 2 * W + 2 * jx + dx) * cout + co0 + c
                    flat[o] = smem[os_off + (dy * tm + p) * orow + q] \
                        .view(np.int8)
                    cnt[o] += 1
    return tiles


# name -> (N, H, W, cin, cout, co_t, grid, mode): int8 (per-channel bias,
# clip 127), w4a4 (+-7 values, per-column bias, clip 7), extremes (+-127)
EMULATED = {
    # ct3's launch (128-pixel tiles, co_t = cout = 32), tiles across
    # input rows (W = 48), the ring running on across three tiles
    "ct3_rows": (1, 8, 48, 64, 32, 32, 1, "int8"),
    # ct2's launch (64-pixel tiles, co_t = cout = 64), four chunks; two
    # blocks along M
    "ct2": (1, 4, 32, 128, 64, 64, 2, "int8"),
    # the w4a4 knobs at ct1's launch (co_t 64 of cout 128, runs of 64
    # bytes), three chunks
    "ct1_w4a4": (1, 2, 48, 96, 128, 64, 1, "w4a4"),
    # ct0's launch (co_t 32 of 256), +-127 inputs and weights
    "ct0_extremes": (1, 4, 32, 64, 256, 32, 1, "extremes"),
    # an edge tile (M = 2*3*10 = 60 of a 64-pixel tile), cin % 32 = 16
    # (a zero-filled unit), cout 40: 4*cout = 160 not a multiple of the
    # block's 128 or 256 columns, byte stores
    "edge_co_t32": (2, 3, 10, 48, 40, 32, 2, "int8"),
    "edge_co_t64": (2, 3, 10, 48, 40, 64, 2, "w4a4"),
    # the CUDA tests' odd shape: cin 12 (the byte gatherer's layout), cout
    # 5 (16-channel blocks of 256 pixels)
    "odd": (1, 3, 5, 12, 5, 16, 1, "int8"),
}


def _emulated_case(name):
    N, H, W, cin, cout, co_t, grid, mode = EMULATED[name]
    rng = np.random.default_rng(len(name) + cin)
    if mode == "extremes":
        x = rng.choice(np.int8([-127, 127]), (N, H, W, cin))
        w = rng.choice(np.int8([-127, 127]), (cin, cout, 2, 2))
        scale = np.float32(rng.uniform(30, 60, cout) / (cin ** 0.5 * 127 ** 2))
        bias = rng.uniform(-5, 5, cout).astype(np.float32)
        clip = 127.0
    elif mode == "w4a4":
        x = rng.integers(-7, 8, (N, H, W, cin)).astype(np.int8)
        w = rng.integers(-7, 8, (cin, cout, 2, 2)).astype(np.int8)
        scale = np.float32(rng.uniform(3, 6, cout) / (cin ** 0.5 * 16))
        bias = rng.uniform(-3, 3, 4 * cout).astype(np.float32)
        clip = 7.0
    else:
        x = rng.integers(-127, 128, (N, H, W, cin)).astype(np.int8)
        w = rng.integers(-127, 128, (cin, cout, 2, 2)).astype(np.int8)
        scale = np.float32(rng.uniform(30, 60, cout) / (cin ** 0.5 * 73 ** 2))
        bias = rng.uniform(-5, 5, cout).astype(np.float32)
        clip = 127.0
    plan = k12.ct2x2_plan_for(N, H, W, cin, cout, co_t)._replace(grid=grid)
    return x, w, scale, bias, clip, plan


@pytest.mark.parametrize("name", list(EMULATED))
def test_emulated_block_equals_the_plain_version(name):
    """One K2 block (the last channel tile, the block that holds the last
    pixel tile) emulated byte for byte equals ``ct2x2_int8_reference``
    exactly on every byte it writes, writes each byte of its tiles'
    pixels and channels once and nothing else."""
    x, w, scale, bias, clip, plan = _emulated_case(name)
    N, H, W, cin = x.shape
    cout = plan.cout
    wp = k12.pack_ct2x2_weights(torch.from_numpy(w))
    want = k12.ct2x2_int8_reference(
        torch.from_numpy(x), wp, torch.from_numpy(scale),
        torch.from_numpy(bias), out_clip=clip).numpy()
    out = np.zeros((N, 2 * H, 2 * W, cout), np.int8)
    count = np.zeros(out.shape, np.int32)
    bx, cb = (plan.units - 1) % plan.grid, plan.n_co - 1
    tiles = _emulate_block(x, wp.numpy(), scale, bias, plan, bx, cb, out,
                           count, clip)
    assert plan.units - 1 in tiles
    M, co0 = N * H * W, cb * plan.co_t
    mine = np.zeros(out.shape, bool)
    for t in tiles:
        for m in range(t * plan.tm, min(M, (t + 1) * plan.tm)):
            r, j = divmod(m, W)
            mine.reshape(N * 2 * H, 2 * W, cout)[
                2 * r:2 * r + 2, 2 * j:2 * j + 2, co0:co0 + plan.co_t] = True
    np.testing.assert_array_equal(count, mine.astype(np.int32))
    np.testing.assert_array_equal(out[mine], want[mine])
    assert len(np.unique(want[mine])) > 3  # not all clipped
    if clip == 7.0:
        assert np.abs(want[mine].astype(np.int32)).max() == 7


@pytest.mark.parametrize("probe,source", [
    ("k1_probe", "conv3x3_int8.cu"), ("k2_probe", "ct2x2_int8.cu"),
    ("k7_probe", "conv7x3_int8.cu")])
def test_probes_find_the_lines_they_edit(probe, source):
    """k1/k2/k7_probe.py build their kernel with copies, products or the
    epilogue taken out by editing lines of the source and of the shared
    header: every edit finds its line and changes its build."""
    import importlib

    mod = importlib.import_module(probe)
    src = (_build.CSRC / source).read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    variants = mod.builds(src, header)
    assert variants["kernel"] == (src, header)
    assert variants["no_copies"][1] != header
    for name, built in variants.items():
        if name != "kernel":
            assert built != (src, header), name
