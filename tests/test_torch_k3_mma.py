"""K3's tensor-core body (``csrc/head_argmax.cu:head_argmax_mma``) on the CPU:
``head_plan`` (tile, slots, shared memory, the alignment of every tile
start, the persistent grid), the ctypes binding, the copies into the
swizzled ring and the ldmatrix reads' bank groups, the B fragments taken
from ``pack_head_weights``' array (and back), and the whole kernel
emulated in numpy block by block: the 16- or 4-byte copies with the
ragged tile zero-filled (over a ring of random bytes: channels past cin
are never written), the m16n8k32 s8 products into accumulators that
start at the bits of 1.5 * 2^23 (the sum's float without a conversion),
the pixel's largest logit (the lane's columns, then the quad's by two xor
shuffles), the lowest class that reaches it (likewise) and the 16-byte
label stores, bit-equal to ``head_argmax_reference`` on random inputs and
on crafted ties (across n8 tiles, across the lanes of a quad, all
classes).

Imports no JAX: ``tests/test_torch_cuda.py`` takes ``crafted_case`` from
here on the card.
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
    head_argmax as k3,
)
from test_torch_conv3x3_mma import (
    _a_matrix,
    _b_matrix,
    _fma,
    _ldmatrix_x4,
    _mma,
    _swz,
)

_LANES = np.arange(32)
_G, _Q = _LANES // 4, _LANES % 4
WARPS = k3.THREADS // 32
# the ldmatrix row of each lane (csrc/head_argmax.cu: a_off, warp 0)
_A_OFF = _swz((_LANES & 7) + 8 * ((_LANES >> 3) & 1), _LANES >> 4)
SMEM_MAX = 232448  # an H100 block's shared memory (227 KB)
MAGIC = 0x4B400000  # csrc/head_argmax.cu: the accumulators' start, 1.5 * 2^23


def crafted_case(rng, P, cin, nc, ties):
    """(x (P, cin), w (nc, cin)) int8 and (scale, bias) (nc,) float32 of a
    K3 case. With ``ties``: every bias equal; classes 2 and 8 copy class
    1's weights and scale (a tie across the lanes of a quad, and one with
    the higher class in the lower lane), class 12 copies class 3's (across
    n8 tiles); the first 40 pixels are zero (every class ties: label 0),
    the next 40 are class 1's weights, the next 40 class 3's (where those
    classes win, their copies tie with them)."""
    x = rng.integers(-127, 128, (P, cin)).astype(np.int8)
    w = rng.integers(-40, 41, (nc, cin)).astype(np.int8)
    std = cin ** 0.5 * 73 * 40
    scale = (rng.uniform(30, 60, nc) / std).astype(np.float32)
    bias = rng.uniform(-5, 5, nc).astype(np.float32)
    if ties:
        bias[:] = 0.5
        for a, b in ((1, 2), (1, 8), (3, 12)):
            if b < nc:
                w[b], scale[b] = w[a], scale[a]
        x[:40] = 0
        for i, a in enumerate((1, 3)):
            if a < nc:
                x[40 * (i + 1):40 * (i + 2)] = w[a]
    return x, w, scale, bias


def _reference(x, w, scale, bias):
    return k3.head_argmax_reference(*(torch.from_numpy(a) for a in
                                      (x, w, scale, bias))).numpy()


def b_fragments(w, ks, nt):
    """The B fragments a lane reads from (nc, cin) ``w``: [s][t][h] ->
    (32 lanes, 4 bytes) int8, the word at class 8t + g, channels 32s +
    16h + 4q, zero past nc and cin."""
    nc, cin = w.shape
    out = np.zeros((ks, nt, 2, 32, 4), np.int8)
    for s in range(ks):
        for t in range(nt):
            for h in range(2):
                n, k = 8 * t + _G, 32 * s + 16 * h + 4 * _Q
                ok = (n < nc) & (k < cin)
                for lane in np.flatnonzero(ok):
                    out[s, t, h, lane] = w[n[lane], k[lane]:k[lane] + 4]
    return out


def _copy_chunks(plan):
    """(pixel, byte offset in the pixel, size, offset in the slot) of every
    copy of a tile (csrc/head_argmax.cu: copy16, load_tile)."""
    ch, cpp = plan.chunk, plan.cin // plan.chunk
    out = []
    for c in range(plan.tile * cpp):
        p, v = divmod(c, cpp)
        if ch == 16:
            dst = (v >> 1) * plan.tile * 32 + _swz(p, v & 1)
        else:
            dst = (v >> 3) * plan.tile * 32 + _swz(p, (v >> 2) & 1) \
                + 4 * (v & 3)
        out.append((p, ch * v, ch, dst))
    return out


def emulate(x, w, scale, bias, plan, seed=0):
    """The kernel over every block of ``plan``: -> (P,) int8 labels."""
    P, nc, tp = plan.P, plan.nc, plan.tile
    slot_bytes = tp * plan.ks * 32
    frags = b_fragments(w, plan.ks, plan.nt)
    B = [[_b_matrix(frags[s, t, 0], frags[s, t, 1]) for t in range(plan.nt)]
         for s in range(plan.ks)]
    chunks = _copy_chunks(plan)
    xb = x.view(np.uint8)
    y = np.full(P, -1, np.int8)
    rng = np.random.default_rng(seed)
    for g in range(plan.grid):
        smem = rng.integers(0, 256, plan.smem).astype(np.uint8)
        for i, tile in enumerate(range(g, plan.tiles, plan.grid)):
            base, p0 = (i % plan.stages) * slot_bytes, tile * tp
            for p, off, n, dst in chunks:
                smem[base + dst:base + dst + n] = (
                    xb[p0 + p, off:off + n] if p0 + p < P else 0)
            for warp in range(WARPS):
                stage = np.zeros(32, np.int8)
                for m in range(2):
                    acc = np.full((plan.nt, 32, 4), MAGIC, np.int64)
                    for s in range(plan.ks):
                        A = _a_matrix(_ldmatrix_x4(
                            smem, base + s * tp * 32 + (32 * warp + 16 * m)
                            * 32 + _A_OFF))
                        for t in range(plan.nt):
                            _mma(acc[t], A, B[s][t])
                    v = np.zeros((plan.nt, 4, 32), np.float32)
                    zm = [np.full(32, -np.inf, np.float32) for _ in range(2)]
                    for t in range(plan.nt):
                        for r in range(4):
                            h, j = r >> 1, r & 1
                            k = 8 * t + 2 * _Q + j
                            kk = np.minimum(k, nc - 1)
                            f = acc[t][:, r].astype(np.int32).view(
                                np.float32) - np.float32(12582912.0)
                            v[t, r] = _fma(f, np.where(
                                k < nc, scale[kk], 0).astype(np.float32),
                                np.where(k < nc, bias[kk], 0).astype(
                                    np.float32))
                            zm[h] = np.where(k < nc, np.maximum(zm[h], v[t, r]),
                                             zm[h])
                    for o in (1, 2):  # __shfl_xor_sync, both halves
                        for h in range(2):
                            zm[h] = np.maximum(zm[h], zm[h][_LANES ^ o])
                    arg = [np.full(32, 32) for _ in range(2)]
                    for t in reversed(range(plan.nt)):
                        for r in reversed(range(4)):
                            h, j = r >> 1, r & 1
                            k = 8 * t + 2 * _Q + j
                            arg[h] = np.where((k < nc) & (v[t, r] == zm[h]), k,
                                              arg[h])
                    for o in (1, 2):
                        for h in range(2):
                            arg[h] = np.minimum(arg[h], arg[h][_LANES ^ o])
                    for h in range(2):
                        stage[16 * m + _G[_Q == 0] + 8 * h] = np.where(
                            arg[h] < 32, arg[h], 0)[_Q == 0]
                for lane in range(2):  # 16-byte stores, bytes at the end
                    p = p0 + 32 * warp + 16 * lane
                    n = min(16, P - p)
                    if n > 0:
                        y[p:p + n] = stage[16 * lane:16 * lane + n]
    return y


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nc", [1, 8, 10, 17, 32])
@pytest.mark.parametrize("cin", [4, 32, 64])
def test_k3_emulation_matches_reference(cin, nc, ties):
    """Three tiles, the last ragged, on two blocks (one of them runs two
    tiles through the ring), bit-equal to the plain version."""
    rng = np.random.default_rng(cin * 100 + nc)
    P = 2 * k3.TILE + 37
    x, w, scale, bias = crafted_case(rng, P, cin, nc, ties)
    plan = k3.head_plan(P, cin, nc, co_resident=2)
    want = _reference(x, w, scale, bias)
    np.testing.assert_array_equal(emulate(x, w, scale, bias, plan), want)
    if ties:
        assert (want[:40] == 0).all()
        assert not np.isin(want, [2, 8, 12]).any()  # copies of 1 and 3


@pytest.mark.parametrize("cin", [12, 16, 36, 48, 60])
def test_k3_emulation_other_loaders(cin):
    """The other copy paths: 16-byte chunks with cin / 16 known only at
    run time (16, 48), and word copies (12, 36, 60), two k-steps where
    cin > 32."""
    rng = np.random.default_rng(cin)
    P = k3.TILE + 5
    x, w, scale, bias = crafted_case(rng, P, cin, 10, True)
    plan = k3.head_plan(P, cin, 10, co_resident=1)
    assert plan.chunk == (16 if cin % 16 == 0 else 4)
    np.testing.assert_array_equal(emulate(x, w, scale, bias, plan),
                                  _reference(x, w, scale, bias))


@pytest.mark.parametrize("cin,nc", [(4, 1), (32, 10), (36, 17), (64, 32)])
def test_b_fragments_round_trip(cin, nc):
    """The fragments, laid back into B by the mma's map, are w transposed
    and zero-padded to ks*32 channels by nt*8 classes."""
    rng = np.random.default_rng(1)
    w = rng.integers(-127, 128, (nc, cin)).astype(np.int8)
    ks, nt = -(-cin // 32), -(-nc // 8)
    f = b_fragments(w, ks, nt)
    B = np.zeros((32 * ks, 8 * nt), np.int64)
    for s in range(ks):
        for t in range(nt):
            B[32 * s:32 * s + 32, 8 * t:8 * t + 8] = _b_matrix(f[s, t, 0],
                                                               f[s, t, 1])
    want = np.zeros_like(B)
    want[:cin, :nc] = w.T
    np.testing.assert_array_equal(B, want)
    packed = k3.pack_head_weights(torch.from_numpy(w)[..., None, None])
    np.testing.assert_array_equal(packed.numpy(), w)


@pytest.mark.parametrize("P", [1, 255, 256, 4097, 32 * 512 * 512])
@pytest.mark.parametrize("cin", [4, 12, 32, 48, 64])
@pytest.mark.parametrize("nc", [1, 10, 32])
def test_head_plan(P, cin, nc):
    """Tiles of 256 pixels (a multiple of 16), every tile start 16-byte
    aligned, the ring and staging rows within a block's shared memory,
    enough of it for several blocks an SM, the grid no larger than the
    co-resident blocks or the tiles."""
    for co_resident in (1, 396, 10 ** 6):
        plan = k3.head_plan(P, cin, nc, co_resident=co_resident)
        assert plan.tile % 16 == 0 and plan.tile == 32 * WARPS
        assert plan.ks == -(-cin // 32) and plan.nt == -(-nc // 8)
        assert plan.stages in (2, 3)
        assert plan.smem == plan.stages * plan.tile * plan.ks * 32 + 256
        assert plan.smem <= SMEM_MAX // 4
        assert plan.tiles * plan.tile >= P > (plan.tiles - 1) * plan.tile
        assert 1 <= plan.grid <= min(plan.tiles, co_resident)
        assert plan.tile * cin % 16 == 0  # tile t starts at t*tile*cin


@pytest.mark.parametrize("cin", [4, 12, 32, 48, 64])
def test_copies_fill_the_slot_once(cin):
    """Every copy of a tile lands inside its slot, 16-byte copies on
    16-byte offsets, no two on the same byte, and the bytes of pixel p's
    k-step s are a 32-byte row's first cin - 32s."""
    plan = k3.head_plan(k3.TILE, cin, 10, co_resident=1)
    slot = plan.tile * plan.ks * 32
    seen = np.zeros(slot, int)
    for p, off, n, dst in _copy_chunks(plan):
        assert 0 <= dst and dst + n <= slot and dst % n == 0
        seen[dst:dst + n] += 1
        s = off // 32
        assert dst // (plan.tile * 32) == s
        row = (dst % (plan.tile * 32)) // 32
        assert row == p
    assert seen.max() == 1 and seen.sum() == plan.tile * cin


@pytest.mark.parametrize("ks", [1, 2])
def test_ldmatrix_reads_are_conflict_free(ks):
    """The 8 rows of every ldmatrix phase (every warp, m16 group and
    k-step) fall in 8 different bank groups and inside the slot."""
    slot = k3.TILE * ks * 32
    for warp in range(WARPS):
        for m in range(2):
            for s in range(ks):
                addr = s * k3.TILE * 32 + (32 * warp + 16 * m) * 32 + _A_OFF
                assert addr.max() + 16 <= slot
                for phase in range(4):
                    groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                    assert len(set(groups.tolist())) == 8


def test_k3_binding_matches_the_c_entry_points():
    """The ctypes argument lists of K3's two entry points have one entry
    per parameter of the C functions: pointers where they take pointers,
    64-bit integers where they take ``long long``."""
    src = (_build.CSRC / "head_argmax.cu").read_text()
    assert "head_argmax_kernel" not in src  # the one-thread-a-pixel body
    for name in ("octseg_head_argmax", "octseg_head_argmax_resident"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           src).group(1).split(",")
        argtypes = _build.SIGNATURES[name]
        assert len(params) == len(argtypes)
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
            assert ("long long" in p) == (t is ctypes.c_longlong), (p, t)


def test_constants_match_the_source():
    """``head_argmax.py``'s threads, tile and slots are the kernel's."""
    src = (_build.CSRC / "head_argmax.cu").read_text()
    for name, value in (("THREADS", k3.THREADS), ("TP", k3.TILE),
                        ("STAGES", k3.STAGES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
