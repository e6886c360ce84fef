"""The port's bf16 training conv (``ops/conv_bf16``: K4 forward and dgrad,
K5 wgrad) against the JAX package's ``conv3x3_psrp_bf16`` with its Pallas
kernels in interpret mode, through ``pack_psrp``/``unpack_psrp``.

On the CPU the wrappers take their plain versions, so this holds the
arithmetic the CUDA kernels are compared with on the card. Inputs are small
integers: every fp32 partial sum is exact, so forward, dx and dw are
bit-equal (the JAX tests' own device, ``tests/test_bf16_conv.py:30-32``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_bf16 import (
    conv3x3_psrp_bf16,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_psrp import (
    pack_psrp,
    unpack_psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_bf16 as k45,
)

CASES = [  # (by, nph, cin, cout, H, W): JAX's packing, and the image size
    (4, 4, 8, 8, 16, 16),
    (2, 2, 8, 16, 16, 16),
    (1, 1, 16, 8, 16, 16),
    (2, 2, 8, 8, 24, 16),  # non-square
]


def _ints(rng, shape, lo=-2, hi=3):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _bf16(a):
    return torch.tensor(a, dtype=torch.bfloat16)


def _jax_fwd_and_grads(x, w, dy, by, nph):
    """JAX forward, dx and dw (dw in bf16, as its VJP casts to w.dtype)."""
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)

    def f(x_, w_):
        y = conv3x3_psrp_bf16(pack_psrp(x_, by, nph), w_, by, nph, 2, True)
        return unpack_psrp(y, by, nph)

    y, vjp = jax.vjp(f, xj, wj)
    dx, dw = vjp(jnp.asarray(dy, jnp.bfloat16))
    return (np.asarray(y, np.float32), np.asarray(dx, np.float32),
            np.asarray(dw, np.float32))


@pytest.mark.parametrize("by,nph,cin,cout,H,W", CASES)
def test_plain_versions_bit_equal_to_jax(by, nph, cin, cout, H, W):
    rng = np.random.default_rng(cin * 100 + cout + H)
    x = _ints(rng, (2, H, W, cin))
    w = _ints(rng, (3, 3, cin, cout))
    dy = _ints(rng, (2, H, W, cout))
    y_j, dx_j, dw_j = _jax_fwd_and_grads(x, w, dy, by, nph)

    xt, wt, dyt = _bf16(x), _bf16(w), _bf16(dy)
    np.testing.assert_array_equal(
        k45.conv3x3_bf16_reference(xt, wt).float().numpy(), y_j)
    np.testing.assert_array_equal(
        k45.conv3x3_bf16_dgrad_reference(dyt, wt).float().numpy(), dx_j)
    dw = k45.conv3x3_bf16_wgrad_reference(xt, dyt)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, cin, cout)
    np.testing.assert_array_equal(dw.bfloat16().float().numpy(), dw_j)

    # the differentiable op: forward through the K4 wrapper, backward
    # through the K4 (on flipped weights) and K5 wrappers
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    y = k45.conv3x3_bf16(xg, wg)
    gx, gw = torch.autograd.grad(y, (xg, wg), dyt)
    assert y.dtype == gx.dtype == gw.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.detach().float().numpy(), y_j)
    np.testing.assert_array_equal(gx.float().numpy(), dx_j)
    np.testing.assert_array_equal(gw.float().numpy(), dw_j)


def test_dgrad_is_forward_on_flipped_weights():
    """K4 serves as the dgrad: the forward plain version on ``flip_w(w)``
    equals the independent transposed-conv plain version."""
    rng = np.random.default_rng(3)
    dy = _bf16(_ints(rng, (2, 8, 12, 6)))
    w = _bf16(_ints(rng, (3, 3, 5, 6)))
    assert k45.flip_w(w).shape == (3, 3, 6, 5)
    assert torch.equal(k45.conv3x3_bf16_fwd(dy, k45.flip_w(w)),
                       k45.conv3x3_bf16_dgrad_reference(dy, w))


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="bf16"):
        k45.conv3x3_bf16(x, torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="device"):
        k45.conv3x3_bf16_fwd(torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16,
                                         device="meta"),
                             torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16))


PLAN_CASES = [(1, 8, 16, 16, 32), (8, 512, 512, 32, 32),
              (8, 32, 32, 512, 512)]
# the default train step's three K5 calls (batch 8, 512^2)
MAIN_PATH = [(8, 512, 512, 32, 32), (8, 512, 512, 64, 32),
             (8, 512, 512, 32, 32)]


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_CASES)
def test_wgrad_groups_bound_the_grid(n, h, w, cin, cout):
    """K5's plan: at most about two blocks per SM of an H100 in all (or one
    per channel tile), its tiles within the kernel's limits, and the bands
    of every block, over every channel tile, cover each (n, row, column
    tile, ci, co) exactly once, each block walking its bands in the fixed
    (n, row, column) order."""
    plan = k45.wgrad_plan(n, h, w, cin, cout)
    tiles = plan.n_ci * plan.n_co
    assert 1 <= plan.G <= plan.units
    assert plan.G * tiles <= max(2 * 132, tiles)
    assert plan.twk % 16 == 0 and plan.twk <= 128
    assert plan.ci_t in (16, 32, 64) and plan.co_t == 32
    assert plan.ci_t * plan.co_t <= 2048
    # the grid is (G, n_ci, n_co): block (g, i, j) takes g's bands for
    # channel tile (i, j), so each (n, row, column tile, ci, co) is covered
    # (blocks g that cover its pixels) x (tiles that cover its channels)
    # times
    pixels = np.zeros((n, h, plan.nct), np.int32)
    for g in range(plan.G):
        order = plan.order(g)
        assert order == sorted(order) and len(set(order)) == len(order)
        for b_n, y0, x0 in order:
            assert y0 % plan.R == 0 and x0 % plan.twk == 0
            pixels[b_n, y0:y0 + plan.R, x0 // plan.twk] += 1
    ci = np.zeros(plan.n_ci * plan.ci_t, np.int32)
    co = np.zeros(plan.n_co * plan.co_t, np.int32)
    for i in range(plan.n_ci):
        ci[i * plan.ci_t:(i + 1) * plan.ci_t] += 1
    for j in range(plan.n_co):
        co[j * plan.co_t:(j + 1) * plan.co_t] += 1
    assert (pixels == 1).all() and (ci == 1).all() and (co == 1).all()
    assert plan.nct * plan.twk >= w > (plan.nct - 1) * plan.twk
    assert plan.n_ci * plan.ci_t >= cin and plan.n_co * plan.co_t >= cout


@pytest.mark.parametrize("n,h,w,cin,cout", MAIN_PATH)
def test_wgrad_plan_reads_each_byte_once(n, h, w, cin, cout):
    """At the default step's shapes the channel tile is all of cin and cout:
    dy is read once, x at most (R+2)/R * (twk+2)/twk times (the halo rows
    and columns)."""
    plan = k45.wgrad_plan(n, h, w, cin, cout)
    assert (plan.n_ci, plan.n_co) == (1, 1)
    x_reads, dy_reads = plan.reads()
    assert dy_reads == 1.0
    assert 1.0 < x_reads <= (plan.R + 2) / plan.R * (plan.twk + 2) / plan.twk


@pytest.mark.parametrize("cin,cout", [(5, 3), (24, 40), (8, 16)])
def test_wgrad_on_padded_channels(cin, cout):
    """K5's wrapper pads the channels to a multiple of 8 and slices dW: the
    plain version on the zero-padded x and dy, sliced back, equals the plain
    version on the originals."""
    rng = np.random.default_rng(cin * 10 + cout)
    x = _bf16(rng.standard_normal((2, 6, 10, cin)))
    dy = _bf16(rng.standard_normal((2, 6, 10, cout)))
    xp, dyp = k45.pad_channels(x), k45.pad_channels(dy)
    assert xp.shape[-1] % 8 == 0 and dyp.shape[-1] % 8 == 0
    assert xp.shape[-1] - cin < 8 and dyp.shape[-1] - cout < 8
    assert xp.is_contiguous() and xp.data_ptr() % 16 == 0
    assert k45.pad_channels(xp) is xp
    if cin % 8 == 0:
        assert xp is x
    want = k45.conv3x3_bf16_wgrad_reference(x, dy)
    got = k45.conv3x3_bf16_wgrad_reference(xp, dyp)[..., :cin, :cout]
    assert torch.equal(got, want)


def test_pad_channels_copies_a_misaligned_tensor():
    """A contiguous bf16 tensor 2 bytes off a 16-byte boundary is copied to
    an aligned one, values unchanged."""
    base = torch.arange(1 + 2 * 2 * 8, dtype=torch.bfloat16)
    t = base[1:].view(1, 2, 2, 8)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    got = k45.pad_channels(t)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)


def test_wgrad_binding_matches_the_c_entry_point():
    """The ctypes argument list of K5 (``ops/_build.py``) has one entry per
    parameter of its C entry point, pointers where the C side takes
    pointers (a mismatch would show only on the card)."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    src = (_build.CSRC / "conv3x3_bf16.cu").read_text()
    params = re.search(r'extern "C" int octseg_conv3x3_bf16_wgrad\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_conv3x3_bf16_wgrad"]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)


# --------------------------------------------------------------- K4's mma.sync body

# the default train step's six K4 calls (batch 8, 512^2): forward and dgrad
# of blk0_conv1, blk8_conv0 (its explicit concat, 64 -> 32; the dgrad 32 ->
# 64 on flip_w) and blk8_conv1
DEFAULT_STEP_K4 = [(8, 512, 512, 32, 32), (8, 512, 512, 64, 32),
                   (8, 512, 512, 32, 32), (8, 512, 512, 32, 32),
                   (8, 512, 512, 32, 64), (8, 512, 512, 32, 32)]


@pytest.mark.parametrize("cin", [16, 32, 48, 64])
@pytest.mark.parametrize("cout", [32, 40, 64])
def test_pack_conv3x3_bf16_weights(cin, cout):
    """The mma.sync body's weights: (nk, 9, coutp, 16), element [j, t, co,
    b] = w[t // 3, t % 3, 16j + b, co], zeros in the padded output
    channels; the unpack inverts it."""
    rng = np.random.default_rng(cin * 100 + cout)
    w = _bf16(rng.standard_normal((3, 3, cin, cout)))
    for co_t in (32, 64):
        wk = k45.pack_conv3x3_bf16_weights(w, co_t)
        coutp = -(-cout // co_t) * co_t
        assert wk.shape == (cin // 16, 9, coutp, 16) and wk.is_contiguous()
        assert torch.equal(k45.unpack_conv3x3_bf16_weights(wk, cin, cout), w)
        for j, t, co, b in [(0, 0, 0, 0), (cin // 16 - 1, 8, cout - 1, 15),
                            (cin // 32, 4, cout // 2, 7)]:
            assert wk[j, t, co, b] == w[t // 3, t % 3, 16 * j + b, co]
        assert not wk[:, :, cout:].any()


@pytest.mark.parametrize("n,h,w,cin,cout", DEFAULT_STEP_K4)
def test_fwd_plan_admits_the_default_step(n, h, w, cin, cout):
    """All six default-step calls go to the mma.sync body: 32 output
    channels a block, two blocks an SM, three ring slots, and the two
    blocks' shared memory within an H100 SM's 228 KB."""
    plan = k45.fwd_plan(n, h, w, cin, cout)
    assert plan.body == "mma" and plan.co_t == 32 and plan.stages == 3
    assert plan.nk == cin // 16 and plan.coutp == cout
    assert plan.blocks_per_sm == 2
    assert plan.smem == k45.mma_smem(plan.co_t, plan.stages)
    assert plan.blocks_per_sm * (plan.smem + k45.BLOCK_SMEM_RESERVED) \
        <= k45.SM_SMEM


@pytest.mark.parametrize("n,h,w,cin,cout,aligned", [
    (1, 7, 9, 5, 3, True), (2, 10, 20, 24, 40, True),
    (2, 10, 20, 40, 24, True), (1, 16, 16, 32, 12, True),
    (1, 16, 16, 32, 32, False),
])
def test_fwd_plan_keeps_the_rest_on_wmma(n, h, w, cin, cout, aligned):
    """cin % 16 != 0, cout % 8 != 0 or a misaligned input: the WMMA body."""
    plan = k45.fwd_plan(n, h, w, cin, cout, aligned)
    assert plan.body == "wmma" and plan.rows == 8 and plan.co_t == 32


@pytest.mark.parametrize("n,h,w,cin,cout", DEFAULT_STEP_K4[:2] + [
    (1, 40, 48, 64, 32), (1, 40, 48, 32, 64), (2, 16, 16, 32, 32),
    (1, 7, 9, 16, 8), (1, 8, 16, 64, 96), (2, 32, 32, 512, 512)])
@pytest.mark.parametrize("co_t", [32, 64])
def test_fwd_plan_tiles_cover_the_output(n, h, w, cin, cout, co_t):
    """The grid's units (tile x channel tile x image) cover every output
    element once; the shared memory of the resident blocks fits an SM."""
    plan = k45.plan_for(n, h, w, cin, cout, "mma", co_t)
    assert plan.tiles_y * plan.rows >= h > (plan.tiles_y - 1) * plan.rows
    assert plan.tiles_x * plan.cols >= w > (plan.tiles_x - 1) * plan.cols
    assert plan.coutp >= cout > plan.coutp - plan.co_t
    assert plan.blocks_per_sm * (plan.smem + k45.BLOCK_SMEM_RESERVED) \
        <= k45.SM_SMEM
    seen = np.zeros((n, plan.tiles_y * plan.rows, plan.tiles_x * plan.cols,
                     plan.coutp), np.int32)
    for u in range(plan.units):
        rest, c = divmod(u, plan.n_co)
        rest, tx = divmod(rest, plan.tiles_x)
        b, ty = divmod(rest, plan.tiles_y)
        seen[b, ty * plan.rows:(ty + 1) * plan.rows,
             tx * plan.cols:(tx + 1) * plan.cols,
             c * plan.co_t:(c + 1) * plan.co_t] += 1
    assert (seen == 1).all()


def test_mma_binding_matches_the_c_entry_point():
    """The ctypes argument list of K4's mma.sync entry point has one entry
    per parameter of the C function, pointers where it takes pointers."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    src = (_build.CSRC / "conv3x3_bf16.cu").read_text()
    params = re.search(r'extern "C" int octseg_conv3x3_bf16_mma\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_conv3x3_bf16_mma"]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)


# The kernel's addressing (csrc/conv3x3_bf16.cu: swz, lane_offsets,
# mma_chunk, the loader and the epilogue), written out in numpy.
_LANES = np.arange(32)
_HALO_W, _KCH = k45.COLS + 2, 32
_HR, _PITCH = k45.ROWS + 2, (k45.COLS + 2) * 32
_HALO = _HR * _PITCH


def _swz(p, u):
    """Byte offset of 16-byte unit u of 32-byte row p."""
    return ((2 * p + u) ^ ((p >> 2) & 1)) * 16


def _lane_offsets(nt):
    a_col = [_swz(kx + (_LANES & 7) + 8 * ((_LANES >> 3) & 1), _LANES >> 4)
             for kx in range(3)]
    b_off = [_swz(16 * j + (_LANES & 7) + 8 * (_LANES >> 4),
                  (_LANES >> 3) & 1) for j in range(nt // 2)]
    return a_col, b_off


@pytest.mark.parametrize("co_t", [32, 64])
def test_k4_swizzle_keeps_ldmatrix_conflict_free(co_t):
    """At K4's halo (34 rows of 18 pixels, 32 bytes a pixel) the 8 rows of
    every ldmatrix phase fall in 8 different bank groups: for every tap,
    tile row and 16-pixel half of the A reads, and for every tap and n8
    pair of the B reads at both channel widths a block."""
    a_col, b_off = _lane_offsets(co_t // 8)
    for ky in range(3):
        for kx in range(3):
            for row in range(k45.ROWS):
                addr = (row + ky) * _PITCH + a_col[kx]
                assert addr.max() + 16 <= _HALO
                for phase in range(4):
                    groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                    assert len(set(groups.tolist())) == 8, (ky, kx, row)
    for tap in range(9):
        for off in b_off:
            addr = _HALO + tap * co_t * _KCH + off
            for phase in range(4):
                groups = (addr[8 * phase:8 * phase + 8] // 16) % 8
                assert len(set(groups.tolist())) == 8


def _bits(t):
    """bf16 tensor -> its uint16 bit patterns (numpy)."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _ldmatrix_x4(smem, addr):
    """ldmatrix.x4 (b16, not transposed): lane l gives the address of row
    l % 8 of matrix l // 8; register i of lane l is bytes 4(l % 4)..+3 of
    row l // 4 of matrix i, as two bf16. -> (32 lanes, 4 registers, 2)."""
    rows = np.stack([smem[a:a + 16].view(np.uint16) for a in addr])
    out = np.empty((32, 4, 2), np.uint16)
    for i in range(4):
        out[:, i] = rows[8 * i + _LANES // 4].reshape(32, 4, 2)[_LANES,
                                                               _LANES % 4]
    return out


def _f32(bits):
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _mma_m16n8k16(acc, a, b0, b1):
    """mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 on every lane's
    registers, by PTX's fragment maps (g = lane / 4, t = lane % 4): A a0
    (g, 2t..2t+1), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..); B b0
    (k 2t..2t+1, column g), b1 (k 2t+8.., g); C c0, c1 (g, 2t, 2t+1), c2,
    c3 (g+8, 2t, 2t+1). acc: (32, 4) float64, updated in place."""
    g, t = _LANES // 4, _LANES % 4
    A, B = np.zeros((16, 16)), np.zeros((16, 8))
    for e in range(2):
        A[g, 2 * t + e] = _f32(a[:, 0, e])
        A[g + 8, 2 * t + e] = _f32(a[:, 1, e])
        A[g, 2 * t + 8 + e] = _f32(a[:, 2, e])
        A[g + 8, 2 * t + 8 + e] = _f32(a[:, 3, e])
        B[2 * t + e, g] = _f32(b0[:, e])
        B[2 * t + 8 + e, g] = _f32(b1[:, e])
    D = A @ B
    acc[:, 0] += D[g, 2 * t]
    acc[:, 1] += D[g, 2 * t + 1]
    acc[:, 2] += D[g + 8, 2 * t]
    acc[:, 3] += D[g + 8, 2 * t + 1]


def _emulate_unit(x, wk, plan, u, y):
    """The block of unit u of conv3x3_bf16_mma: the loader's swizzled halo
    and weight copies into ring slot j % stages for chunk j, every warp's
    ldmatrix reads and m16n8k16 products per chunk and tap, the epilogue's
    bf16 tile and its 16-byte stores into y (uint16 bits)."""
    _, H, W, cin = x.shape
    nt, co_t = plan.co_t // 8, plan.co_t
    rest, cb = divmod(u, plan.n_co)
    n, tile = divmod(rest, plan.tiles_y * plan.tiles_x)
    ty, tx = divmod(tile, plan.tiles_x)
    ty0, tx0, co0 = ty * k45.ROWS, tx * k45.COLS, cb * co_t
    xb, wb = _bits(x), _bits(wk)
    smem = np.zeros(plan.smem, np.uint8)
    stage = _HALO + 9 * co_t * _KCH
    a_col, b_off = _lane_offsets(nt)
    acc = np.zeros((8, 4, nt, 32, 4))  # warp, m, n8 tile, lane, c0..c3
    for j in range(plan.nk):
        off = (j % plan.stages) * stage
        for e in range(_HR * _HALO_W * 2):
            u, p = e & 1, e >> 1
            hr, hc = divmod(p, _HALO_W)
            iy, ix = ty0 - 1 + hr, tx0 - 1 + hc
            src = (xb[n, iy, ix, 16 * j + 8 * u:16 * j + 8 * u + 8]
                   if 0 <= iy < H and 0 <= ix < W else np.zeros(8, np.uint16))
            dst = off + hr * _PITCH + _swz(hc, u)
            smem[dst:dst + 16] = src.view(np.uint8)
        for e in range(9 * co_t * 2):
            u, r = e & 1, e >> 1
            tap, co = divmod(r, co_t)
            dst = off + _HALO + tap * co_t * _KCH + _swz(co, u)
            smem[dst:dst + 16] = wb[j, tap, co0 + co, 8 * u:8 * u + 8] \
                .view(np.uint8)
        for warp in range(8):  # mma_chunk: per kx, three taps' B, then
            a_rows = off + warp * 4 * _PITCH  # each halo row r once
            for kx in range(3):
                b = []
                for ky in range(3):
                    bt = off + _HALO + (ky * 3 + kx) * nt * 8 * _KCH
                    b.append([])
                    for jj in range(nt // 2):
                        r = _ldmatrix_x4(smem, bt + b_off[jj])
                        b[ky] += [(r[:, 0], r[:, 1]), (r[:, 2], r[:, 3])]
                for row in range(4 + 2):
                    a = _ldmatrix_x4(smem, a_rows + row * _PITCH + a_col[kx])
                    for ky in range(3):
                        if 0 <= row - ky < 4:
                            for t in range(nt):
                                _mma_m16n8k16(acc[warp, row - ky, t], a,
                                              *b[ky][t])
    op = 2 * co_t + 16
    tile = np.zeros(k45.ROWS * k45.COLS * op, np.uint8)
    rounded = _bits(torch.tensor(acc.astype(np.float32)).to(torch.bfloat16))
    for warp in range(8):
        for t in range(nt):
            c = 8 * t + 2 * (_LANES & 3)
            for m in range(4):
                for h in range(2):
                    px = (warp * 4 + m) * k45.COLS + (_LANES >> 2) + 8 * h
                    pair = rounded[warp, m, t, :, 2 * h:2 * h + 2]
                    for lane in range(32):
                        o = px[lane] * op + 2 * c[lane]
                        tile[o:o + 4] = pair[lane].view(np.uint8)
    upp = co_t // 8
    for e in range(k45.ROWS * k45.COLS * upp):
        px, u = divmod(e, upp)
        oy, ox, co = ty0 + px // k45.COLS, tx0 + px % k45.COLS, co0 + 8 * u
        if oy < H and ox < W and co < y.shape[-1]:
            y[n, oy, ox, co:co + 8] = tile[px * op + 16 * u:
                                           px * op + 16 * u + 16].view(np.uint16)


@pytest.mark.parametrize("co_t", [32, 64])
def test_emulated_mma_block_equals_the_plain_version(co_t):
    """One mma.sync block emulated byte for byte from the packed, swizzled
    shared memory through every lane's ldmatrix and the m16n8k16 bf16
    fragment maps equals ``conv3x3_bf16_reference`` exactly on small
    integers (every fp32 partial sum exact): at the top-left corner (halo
    outside the image on two sides), inside the image, and at the partial
    bottom-right tile; 64 input channels (4 chunks, the ring wraps) into
    40 outputs (a partial channel tile)."""
    rng = np.random.default_rng(co_t)
    cin, cout = 64, 40
    x = _bf16(_ints(rng, (2, 72, 40, cin)))
    w = _bf16(_ints(rng, (3, 3, cin, cout)))
    plan = k45.plan_for(2, 72, 40, cin, cout, "mma", co_t)
    assert (plan.nk, plan.stages) == (4, 3) and plan.n_co == 64 // co_t
    wk = k45.pack_conv3x3_bf16_weights(w, co_t)
    want = _bits(k45.conv3x3_bf16_reference(x, w))
    tiles = plan.tiles_y * plan.tiles_x
    for n, ty, tx in [(0, 0, 0), (1, 1, 1), (1, 2, 2)]:
        y = np.zeros_like(want)
        for cb in range(plan.n_co):
            u = ((n * tiles) + ty * plan.tiles_x + tx) * plan.n_co + cb
            _emulate_unit(x, wk, plan, u, y)
        r0, c0 = ty * k45.ROWS, tx * k45.COLS
        region = (n, slice(r0, r0 + k45.ROWS), slice(c0, c0 + k45.COLS))
        np.testing.assert_array_equal(y[region], want[region])
        assert want[region].any()
