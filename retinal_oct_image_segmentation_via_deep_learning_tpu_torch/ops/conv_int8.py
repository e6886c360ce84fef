"""Int8 convolutions of the serving path: K1 (3x3) and K2 (2x2/2
transposed), and K11, the standalone 2x2/2 max-pool of the row-packed graph.

K1 and K2 take NHWC int8 activations, contiguous, and end in the same fused
requant: ``v = fmaf(float(acc), scale[co], bias[co])``, then (K1 only) relu,
then round-half-even, clip to [-out_clip, out_clip], int8. ``scale =
(s_in*s_w)/s_out`` and ``bias = b/s_out`` are per output channel, float32
(K2's bias may also be per output column, ``4*cout`` values).

The w4a4 serving mode stores 4-bit values in int8 and reuses these kernels:
``out_clip=7`` for a 4-bit consumer, ``pad_vals`` (-7, the stored zero of a
zero-point-7 input) for the borders, and K1's split-scale pool
(``pool_rescale``, ``pool_shift``, ``pool_clip``), which requantizes the
pooled tensor from the float32 values before rounding while the unpooled
output keeps its own scale. The TPU kernels' ``dot_int4`` only picks the
MXU's int4 rate; the card has no int4 tensor-core path, and the int32 dot
of +-7 operands is exact in int8 arithmetic, so it has no counterpart here.

K1 can also end in the 1x1 classifier head and argmax (``head``): it then
returns the labels only, and its int8 output never reaches device memory.

K11 (``pool2x2_int8``) takes the max of each 2x2 window of an NHWC int8
tensor.

Each wrapper runs its CUDA kernel (``csrc/``) for a CUDA tensor, and its
plain PyTorch version (``*_reference``) only for a CPU tensor. The plain
versions do the products in float64, which is exact here (|acc| reaches
9*512*127^2 ~ 7.4e7 > 2^24, beyond float32), and emulate each FMA as
``(a as double * b + c)`` rounded once to float32 (the product of two
float32 values is exact in float64).

Weights are packed once, at quantize time, into the order the kernels read
(``pack_conv3x3_weights``, ``pack_ct2x2_weights``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import torch
import torch.nn.functional as F

from . import _build


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def fma_reference(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``fmaf(a, b, c)``: the product in float64 (exact for float32
    factors), the sum rounded once to float32."""
    return (a.double() * b.double() + c.double()).float()


def round_clip_reference(v: torch.Tensor, clip: float) -> torch.Tensor:
    """float32 -> int8: round-half-even, clip to [-clip, clip]."""
    return torch.round(v).clamp(-clip, clip).to(torch.int8)


def requant_reference(acc: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, *, relu: bool,
                      out_clip: float = 127.0) -> torch.Tensor:
    """float64 integer accumulators (channels last) -> int8, the kernels'
    epilogue: FMA, relu, round-half-even, clip +-out_clip."""
    v = fma_reference(acc.float(), scale, bias)
    if relu:
        v = v.clamp_min(0.0)
    return round_clip_reference(v, out_clip)


# ---------------------------------------------------------------------------
# K1: 3x3 conv (replaces conv3x3_psrp, stem_psrp and conv3x3_int8 on the TPU)
# ---------------------------------------------------------------------------


def conv3x3_chunk(cin: int) -> int:
    """Padded input-channel count of the packed weights: the kernel reads
    channels in chunks of 4 (cin <= 4, the stem) or 32."""
    return 4 if cin <= 4 else _round_up(cin, 32)


def pack_conv3x3_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(cout, cin, 3, 3) int8 -> (9, cinp/4, coutp, 4) int8: int32 word
    [t, j, co] holds w[co, 4j..4j+3, t//3, t%3]; zero padding to cinp
    (``conv3x3_chunk``) and coutp (a multiple of 32)."""
    cout, cin, kh, kw = w_q.shape
    assert (kh, kw) == (3, 3) and w_q.dtype == torch.int8, w_q.shape
    cinp, coutp = conv3x3_chunk(cin), _round_up(cout, 32)
    dense = torch.zeros(9, cinp, coutp, dtype=torch.int8, device=w_q.device)
    dense[:, :cin, :cout] = w_q.permute(2, 3, 1, 0).reshape(9, cin, cout)
    return (dense.reshape(9, cinp // 4, 4, coutp).permute(0, 1, 3, 2)
            .contiguous())


def unpack_conv3x3_weights(w: torch.Tensor, cin: int,
                           cout: int) -> torch.Tensor:
    """Inverse of ``pack_conv3x3_weights``: (cout, cin, 3, 3) int8."""
    nine, cw, coutp, four = w.shape
    dense = w.permute(0, 1, 3, 2).reshape(9, cw * 4, coutp)[:, :cin, :cout]
    return dense.reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


# the mma.sync body's fixed sizes (csrc/conv3x3_int8.cu): MW tile rows of
# COLS pixels a warp (a block of 8 or 4 warps has a tile of 32 or 16 rows),
# K chunks of KCHUNK bytes a pixel, the head's largest class count, and the
# shared memory of an H100 SM and the part each resident block reserves
MW, COLS, KCHUNK = 4, 16, 32
HEAD_MAX_CLASSES = 32
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024
H100_SMS = 132
# the stem body's fixed sizes: tiles of STEM_WARPS whole image rows (one a
# warp), halo rows padded by STEM_PAD bytes on either side, weight rows of
# STEM_K bytes (tap (ky, kx) at byte 4*ky + kx), and the widths it takes
STEM_WARPS, STEM_PAD, STEM_K = 8, 16, 16
STEM_COUTS = (16, 32, 64)


def pack_conv3x3_mma_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(cout, cin, 3, 3) int8 -> the mma.sync body's weights (nk, 9, coutp,
    32) int8, K-contiguous per output channel (the tensor cores' B
    operand): [j, t, co, b] = w[co, 32j + b, t // 3, t % 3]; cin padded to
    nk * 32 and cout to coutp (a multiple of 32) with zeros."""
    cout, cin, kh, kw = w_q.shape
    assert (kh, kw) == (3, 3) and w_q.dtype == torch.int8, w_q.shape
    cinp, coutp = _round_up(cin, KCHUNK), _round_up(cout, 32)
    dense = torch.zeros(9, cinp, coutp, dtype=torch.int8, device=w_q.device)
    dense[:, :cin, :cout] = w_q.permute(2, 3, 1, 0).reshape(9, cin, cout)
    return (dense.reshape(9, cinp // KCHUNK, KCHUNK, coutp)
            .permute(1, 0, 3, 2).contiguous())


def unpack_conv3x3_mma_weights(w: torch.Tensor, cin: int,
                               cout: int) -> torch.Tensor:
    """Inverse of ``pack_conv3x3_mma_weights``: (cout, cin, 3, 3) int8."""
    nk, nine, coutp, _ = w.shape
    dense = w.permute(1, 0, 3, 2).reshape(9, nk * KCHUNK, coutp)
    return dense[:, :cin, :cout].reshape(3, 3, cin, cout).permute(3, 2, 0, 1)


def mma_weights_from_dp4a(w: torch.Tensor) -> torch.Tensor:
    """``pack_conv3x3_weights`` (9, cinp/4, coutp, 4) with cinp a multiple
    of 32 -> ``pack_conv3x3_mma_weights`` of the same weights, in one
    copy: chunk j's 32 bytes are the words 8j..8j+7."""
    nine, cw, coutp, four = w.shape
    return (w.reshape(9, cw // 8, 8, coutp, 4).permute(1, 0, 3, 2, 4)
            .reshape(cw // 8, 9, coutp, KCHUNK).contiguous())


def stem_channel_order(cout: int) -> torch.Tensor:
    """The stem body's output channel of each GEMM column n = 8j + c (column
    c of n8 tile j): (cout/4)(c // 2) + 2j + c % 2, so the C fragment's
    columns 2t, 2t+1 of every n8 tile give lane t cout/4 consecutive
    channels. cout a multiple of 8."""
    n = torch.arange(cout)
    j, c = n // 8, n % 8
    return (cout // 4) * (c // 2) + 2 * j + c % 2


def pack_stem_mma_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(cout, 1, 3, 3) int8 -> the stem body's weights (coutp, STEM_K) int8:
    row n holds output channel ``stem_channel_order(coutp)[n]``, byte 4*ky
    + kx its tap (ky, kx); bytes 4*ky + 3 and 12-15 are zero, and so are
    the rows of channels >= cout (coutp: cout rounded up to 8)."""
    cout, cin, kh, kw = w_q.shape
    assert (cin, kh, kw) == (1, 3, 3) and w_q.dtype == torch.int8, w_q.shape
    coutp = _round_up(cout, 8)
    rows = torch.zeros(coutp, 4, 4, dtype=torch.int8, device=w_q.device)
    rows[:cout, :3, :3] = w_q[:, 0]
    order = stem_channel_order(coutp).to(w_q.device)
    return rows.reshape(coutp, STEM_K)[order].contiguous()


def unpack_stem_mma_weights(w: torch.Tensor, cout: int) -> torch.Tensor:
    """Inverse of ``pack_stem_mma_weights``: (cout, 1, 3, 3) int8."""
    coutp = w.shape[0]
    order = stem_channel_order(coutp).to(w.device)
    rows = torch.empty_like(w)
    rows[order] = w
    return rows.reshape(coutp, 4, 4)[:cout, None, :3, :3].contiguous()


def stem_weights_from_dp4a(w: torch.Tensor, cout: int) -> torch.Tensor:
    """``pack_conv3x3_weights`` of (cout, 1, 3, 3) weights -> their
    ``pack_stem_mma_weights``."""
    return pack_stem_mma_weights(unpack_conv3x3_weights(w, 1, cout))


def stem_smem(W: int) -> int:
    """Dynamic shared memory of one stem block (the C side computes the
    same): two buffers of STEM_WARPS + 2 halo rows of W + 2*STEM_PAD
    bytes."""
    return 2 * (STEM_WARPS + 2) * (W + 2 * STEM_PAD)


class Conv3x3Plan(NamedTuple):
    """K1's launch for one call (``conv3x3_plan``). ``body`` "mma": the
    output is cut into units of ``rows`` x COLS pixels (rows = MW x
    ``warps``, the block's warps) by ``co_t`` output channels, one block a
    unit, numbered u = ((n * tiles_y + ty) * tiles_x + tx) * n_co +
    channel tile (the grid is (tiles of an image x n_co, N), the channel
    tile fastest, so the blocks that read one tile's input run side by
    side and the second read comes from L2); the nk K chunks (32 channels
    of one input) pass through a ring of ``stages`` shared-memory slots,
    ``smem`` bytes of dynamic shared memory a block, ``blocks_per_sm``
    resident blocks (the kernel's ``__launch_bounds__``). ``body`` "stem":
    tiles of ``warps`` (STEM_WARPS) whole image rows by all ``co_t`` =
    cout channels, numbered u = n * tiles_y + ty, walked by a persistent
    grid of ``grid`` blocks (block b takes u = b, b + grid, ...); the
    halo passes through ``stages`` = 2 buffers. ``body`` "dp4a": the first
    design (16 x 16 tiles, 32 output channels a block, static shared
    memory); the other fields are 0."""

    N: int
    H: int
    W: int
    cin0: int
    cin1: int
    cout: int
    head: bool
    body: str
    co_t: int
    warps: int
    nk: int
    stages: int
    blocks_per_sm: int
    smem: int
    grid: int = 0

    @property
    def rows(self) -> int:
        return self.warps if self.body == "stem" else MW * self.warps

    @property
    def tiles_y(self) -> int:
        return -(-self.H // self.rows)

    @property
    def tiles_x(self) -> int:
        return 1 if self.body == "stem" else -(-self.W // COLS)

    @property
    def n_co(self) -> int:
        return self.cout // self.co_t

    @property
    def units(self) -> int:
        return self.N * self.tiles_y * self.tiles_x * self.n_co


def mma_smem(co_t: int, stages: int, warps: int) -> int:
    """Dynamic shared memory of one mma.sync block (the C side computes the
    same): ``stages`` ring slots of a (rows+2) x (COLS+2) x 32-byte halo
    chunk and the chunk's 9 x co_t weight rows of 32 bytes. After the
    products the ring holds the epilogue's int8 tile (rows of co_t + 16
    bytes) and after it the pooled tile (the same rows) or the head's
    weights, scales and biases."""
    rows = MW * warps
    ring = stages * ((rows + 2) * (COLS + 2) + 9 * co_t) * KCHUNK
    out = rows * COLS * (co_t + 16)
    extra = max(rows * COLS // 4 * (co_t + 16),
                HEAD_MAX_CLASSES * (co_t + 8))
    return max(ring, out + extra)


def plan_for(N: int, H: int, W: int, cins: tuple, cout: int, head: bool,
             co_t: int, warps: int = 8) -> Conv3x3Plan:
    """The mma.sync body's plan at ``co_t`` output channels and ``warps``
    warps a block, admitted or not (``conv3x3_plan`` chooses). Blocks of 8
    warps: three ring slots where there are two chunks or more; two
    resident blocks an SM at co_t 32 (64 int32 accumulators a thread), one
    at co_t 64 (128). Blocks of 4 warps (co_t 32): two slots, four blocks
    an SM. Fewer where the shared memory would not hold them."""
    cin0, cin1 = cins[0], (cins[1] if len(cins) > 1 else 0)
    nk = -(-(cin0 + cin1) // KCHUNK)
    stages = 3 if nk >= 2 and warps == 8 else 2
    smem = mma_smem(co_t, stages, warps)
    by_regs = 4 if warps == 4 else 2 if co_t == 32 else 1
    return Conv3x3Plan(N, H, W, cin0, cin1, cout, bool(head), "mma", co_t,
                       warps, nk, stages,
                       min(by_regs, SM_SMEM // (smem + BLOCK_SMEM_RESERVED)),
                       smem)


@functools.lru_cache(maxsize=256)
def conv3x3_plan(N: int, H: int, W: int, cins: tuple, cout: int,
                 head: bool = False, aligned: bool = True,
                 pool: bool = False, sms: int = H100_SMS) -> Conv3x3Plan:
    """K1's plan for inputs of ``cins`` channels (one or two), H x W, cout
    outputs, pooled or not, ending in the head or not. ``aligned``: every
    input pointer is 16-byte aligned (the weights and the outputs are fresh
    tensors); ``sms``: the card's SM count.

    The stem body takes one input of one channel, cout 16, 32 or 64 (a
    lane's cout/4 bytes of a pixel leave in one 4-, 8- or 16-byte store), W
    a multiple of 16 (whole m16 tiles a row, 16-byte copies of the halo
    rows), an aligned input, no pool and no head, where the shared memory
    holds a block's two halo buffers: every stem of the served PSRP and
    packed graphs at f = 16 and 32. Resident blocks an SM: four at cout 16
    and 32 (the kernel's ``__launch_bounds__``), two at 64, fewer where the
    shared memory would not hold them; the grid is persistent, that many
    blocks an SM, or one a tile where there are fewer tiles.

    The mma.sync body takes the call when every input's channel count is a
    multiple of 32 (a K chunk lies inside one input and is copied 16 bytes
    at a time), cout is a multiple of 32 (whole channel tiles, 16-byte
    stores), the inputs are aligned and, with the head, cout is 32 (one
    channel tile holds a pixel's outputs). That is every call of the served
    U-Net at f = 32 but the stem. Every other call (odd channel counts,
    stems of other widths or shapes, misaligned inputs) stays on the dp4a
    body.

    Output channels a block: 64 where cout allows and the tile has 8 or
    more K chunks, else 32; warps a block: 4 (16 x 16 tiles) at one
    chunk, else 8 (32 x 16). A tile of 1-2 chunks (the 512^2 and 256^2
    stages) is too short a loop for a ring inside one block to hide its
    copies or its epilogue; the overlap comes from other resident blocks,
    which multiply while one copies or stores: two blocks of 8 warps an SM
    at 32 channels (64 int32 accumulators a thread), four of 4 warps at
    one chunk (3-5% faster there, 1-4% slower at two chunks). From 8
    chunks on the ring hides the copies, and 64 channels a block (one an
    SM) halve the halo's reads and the ldmatrix traffic per product; at 4
    chunks 32 channels were as fast or faster. (Device times at the 17
    calls of the served forward: ``k1_probe.py``, PERF.md section 6.)"""
    cins = tuple(cins)
    cin0, cin1 = cins[0], (cins[1] if len(cins) > 1 else 0)
    stem_per_sm = min(4 if cout <= 32 else 2,
                      SM_SMEM // (stem_smem(W) + BLOCK_SMEM_RESERVED))
    if (cins == (1,) and cout in STEM_COUTS and W % 16 == 0 and aligned
            and not head and not pool and stem_per_sm >= 1):
        tiles = N * -(-H // STEM_WARPS)
        return Conv3x3Plan(N, H, W, 1, 0, cout, False, "stem", cout,
                           STEM_WARPS, 1, 2, stem_per_sm, stem_smem(W),
                           min(tiles, stem_per_sm * sms))
    if not (len(cins) <= 2 and cin0 >= KCHUNK and cin0 % KCHUNK == 0
            and cin1 % KCHUNK == 0 and cout >= 32 and cout % 32 == 0
            and aligned and (not head or cout == 32)):
        return Conv3x3Plan(N, H, W, cin0, cin1, cout, bool(head), "dp4a",
                           0, 0, 0, 0, 0, 0)
    nk = (cin0 + cin1) // KCHUNK
    co_t = 64 if cout % 64 == 0 and nk >= 8 and not head else 32
    return plan_for(N, H, W, cins, cout, head, co_t, 4 if nk == 1 else 8)


def conv3x3_int8_reference(inputs: Sequence[torch.Tensor], w: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor, *,
                           relu: bool = True, pool: bool = False,
                           out_clip: float = 127.0, pad_vals=None,
                           pool_rescale: float | None = None,
                           pool_shift: float = 0.0, pool_clip=None,
                           head=None, w_mma=None):
    """Plain version of K1 (any device); the arguments are K1's (it reads
    ``w`` and leaves ``w_mma``, the same weights in another order)."""
    inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) else (inputs,)
    pad_vals = tuple(pad_vals) if pad_vals else (0,) * len(inputs)
    x = torch.cat([F.pad(t.permute(0, 3, 1, 2).double(), (1, 1, 1, 1),
                         value=float(pv))
                   for t, pv in zip(inputs, pad_vals)], dim=1)
    cout = scale.shape[0]
    wd = unpack_conv3x3_weights(w, x.shape[1], cout).double()
    acc = F.conv2d(x, wd).permute(0, 2, 3, 1)
    v = fma_reference(acc.float(), scale, bias)
    if relu:
        v = v.clamp_min(0.0)
    y = round_clip_reference(v, out_clip).contiguous()
    if head is not None:
        from .head_argmax import head_argmax_reference  # it imports us

        return head_argmax_reference(y, *head)
    if not pool:
        return y
    n, h, wd_, c = v.shape
    m = v.reshape(n, h // 2, 2, wd_ // 2, 2, c).amax(dim=(2, 4))
    if pool_rescale is not None:
        m = fma_reference(m, torch.tensor(pool_rescale, dtype=torch.float32),
                          torch.tensor(pool_shift, dtype=torch.float32))
    clip = out_clip if pool_clip is None else pool_clip
    return y, round_clip_reference(m, clip).contiguous()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda_int8(t: torch.Tensor, ndim: int, what: str,
                     device: torch.device) -> None:
    _check(t.device == device, f"{what}: on {t.device}, expected {device}")
    _check(t.dtype == torch.int8, f"{what}: dtype {t.dtype}, expected int8")
    _check(t.dim() == ndim, f"{what}: {t.dim()}-D, expected {ndim}-D")
    _check(t.is_contiguous(), f"{what}: not contiguous")
    _check(t.data_ptr() % 4 == 0, f"{what}: not 4-byte aligned")


def _check_vec(t: torch.Tensor, n: int, what: str,
               device: torch.device) -> None:
    _check(t.device == device and t.dtype == torch.float32
           and t.shape == (n,) and t.is_contiguous(),
           f"{what}: expected contiguous float32 ({n},) on {device}, got "
           f"{tuple(t.shape)} {t.dtype} on {t.device}")


HEAD_MAX_COUT = 32  # the head reads one 32-channel block of K1's output


def conv3x3_int8(inputs, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, *, relu: bool = True,
                 pool: bool = False, out_clip: float = 127.0,
                 pad_vals=None, pool_rescale: float | None = None,
                 pool_shift: float = 0.0, pool_clip: float | None = None,
                 head=None, w_mma: torch.Tensor | None = None):
    """K1: int8 3x3 'same' conv over the channel concat of 1-2 NHWC inputs.

    inputs: one (N, H, W, C) int8 tensor or a tuple of two (the concat is
    folded into the kernel: no ``torch.cat`` is made). w:
    ``pack_conv3x3_weights`` of the (cout, sum C, 3, 3) weights. Returns
    (N, H, W, cout) int8; with ``pool=True`` also its 2x2/2 max-pool.

    The body is ``conv3x3_plan``'s: the tensor-core (mma.sync) body reads
    ``w_mma``, ``pack_conv3x3_mma_weights`` of the same weights, and the
    stem body ``pack_stem_mma_weights``, both packed once at quantize time;
    given none, an admitted call packs them from ``w``. The dp4a body (odd
    channel counts, other stems) reads ``w``.

    ``out_clip``: the requant's clip bound (127, or 7 for a 4-bit
    consumer). ``pad_vals``: one border value per input (default 0; -7 for
    a zero-point-7 input). The pooled output is
    ``clip(rint(fmaf(m, pool_rescale, pool_shift)), +-pool_clip)`` of the
    float32 max ``m`` of each window before rounding; by default
    (no rescale, ``pool_clip = out_clip``) that is the max of the int8
    outputs. ``head=(w_head, hscale, hbias)`` (``head_argmax``'s packed
    weights and epilogue; cout <= 32, a multiple of 4, cin > 4, no pool)
    ends in the 1x1 head and argmax and returns only the (N, H, W) int8
    labels.
    """
    inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) else (inputs,)
    knobs = dict(relu=relu, pool=pool, out_clip=out_clip, pad_vals=pad_vals,
                 pool_rescale=pool_rescale, pool_shift=pool_shift,
                 pool_clip=pool_clip, head=head)
    x0 = inputs[0]
    cout = scale.shape[0]
    nc = 0
    if head is not None:
        nc = head[1].shape[0]
        _check(not pool and cout <= HEAD_MAX_COUT and cout % 4 == 0
               and x0.shape[-1] + sum(t.shape[-1] for t in inputs[1:]) > 4,
               f"conv3x3_int8: the head needs cout <= {HEAD_MAX_COUT}, a "
               f"multiple of 4, more than 4 input channels and no pool; got "
               f"cout {cout}, pool {pool}")
        _check(1 <= nc <= HEAD_MAX_CLASSES,
               f"conv3x3_int8: {nc} head classes, at most "
               f"{HEAD_MAX_CLASSES}")
    if x0.device.type == "cpu":
        return conv3x3_int8_reference(inputs, w, scale, bias, **knobs)
    dev = x0.device
    _check(dev.type == "cuda", f"conv3x3_int8: unsupported device {dev}")
    _check(1 <= len(inputs) <= 2, "conv3x3_int8: one or two inputs")
    for k, t in enumerate(inputs):
        _check_cuda_int8(t, 4, f"conv3x3_int8 input {k}", dev)
        _check(t.shape[:3] == x0.shape[:3],
               f"conv3x3_int8: input shapes {[tuple(t.shape) for t in inputs]}")
    N, H, W, cin0 = x0.shape
    cin1 = inputs[1].shape[-1] if len(inputs) > 1 else 0
    _check_cuda_int8(w, 4, "conv3x3_int8 weights", dev)
    cinp, coutp = conv3x3_chunk(cin0 + cin1), _round_up(cout, 32)
    _check(tuple(w.shape) == (9, cinp // 4, coutp, 4),
           f"conv3x3_int8: weights {tuple(w.shape)}, expected "
           f"{(9, cinp // 4, coutp, 4)}")
    _check_vec(scale, cout, "conv3x3_int8 scale", dev)
    _check_vec(bias, cout, "conv3x3_int8 bias", dev)
    _check(not pool or (H % 2 == 0 and W % 2 == 0),
           f"conv3x3_int8: pool needs even H, W, got {(H, W)}")
    pads = tuple(pad_vals) if pad_vals else (0,) * len(inputs)
    _check(len(pads) == len(inputs) and all(-128 <= p <= 127 for p in pads),
           f"conv3x3_int8: pad_vals {pad_vals} for {len(inputs)} input(s)")
    x1 = inputs[1] if len(inputs) > 1 else None
    plan = conv3x3_plan(N, H, W, tuple(t.shape[-1] for t in inputs), cout,
                        head is not None,
                        all(t.data_ptr() % 16 == 0 for t in inputs), pool,
                        _sm_count(dev.index if dev.index is not None
                                  else torch.cuda.current_device()))
    if plan.body != "dp4a":
        clips = (out_clip, out_clip if pool_clip is None else pool_clip)
        _check(all(float(c).is_integer() and 0 <= c <= 127 for c in clips),
               f"conv3x3_int8: clips {clips}: integers in [0, 127]")
    if plan.body == "stem":
        if w_mma is None:
            w_mma = stem_weights_from_dp4a(w, cout)
        _check_cuda_int8(w_mma, 2, "conv3x3_int8 stem weights", dev)
        _check(tuple(w_mma.shape) == (cout, STEM_K)
               and w_mma.data_ptr() % 16 == 0,
               f"conv3x3_int8: stem weights {tuple(w_mma.shape)}, expected "
               f"16-byte aligned {(cout, STEM_K)}")
    elif plan.body == "mma":
        if w_mma is None:
            w_mma = mma_weights_from_dp4a(w)
        _check_cuda_int8(w_mma, 4, "conv3x3_int8 mma weights", dev)
        _check(tuple(w_mma.shape) == (plan.nk, 9, cout, KCHUNK)
               and w_mma.data_ptr() % 16 == 0,
               f"conv3x3_int8: mma weights {tuple(w_mma.shape)}, expected "
               f"16-byte aligned {(plan.nk, 9, cout, KCHUNK)}")
    hw = hs = hb = lab = None
    if head is not None:
        hw, hs, hb = head
        _check_cuda_int8(hw, 2, "conv3x3_int8 head weights", dev)
        _check(tuple(hw.shape) == (nc, cout),
               f"conv3x3_int8: head weights {tuple(hw.shape)}, expected "
               f"{(nc, cout)}")
        _check_vec(hs, nc, "conv3x3_int8 head scale", dev)
        _check_vec(hb, nc, "conv3x3_int8 head bias", dev)
        lab = torch.empty((N, H, W), dtype=torch.int8, device=dev)
        y = yp = None
    else:
        y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
        yp = (torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8,
                          device=dev) if pool else None)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    epi = (int(relu), pads[0], pads[1] if x1 is not None else 0,
           float(out_clip),
           1.0 if pool_rescale is None else float(pool_rescale),
           float(pool_shift) if pool_rescale is not None else 0.0,
           float(out_clip if pool_clip is None else pool_clip), ptr(hw),
           ptr(hs), ptr(hb), nc, ptr(lab))
    with torch.cuda.device(dev):
        if plan.body == "stem":
            err = _build.lib().octseg_conv3x3_int8_stem(
                x0.data_ptr(), w_mma.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), N, H, W, cout, int(relu),
                pads[0], float(out_clip), plan.grid, plan.smem, _stream(x0))
        elif plan.body == "mma":
            err = _build.lib().octseg_conv3x3_int8_mma(
                x0.data_ptr(), cin0, ptr(x1), cin1, w_mma.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), ptr(y), ptr(yp), N, H, W,
                cout, *epi, plan.co_t, plan.warps, plan.nk, plan.stages,
                plan.smem, _stream(x0))
        else:
            err = _build.lib().octseg_conv3x3_int8(
                x0.data_ptr(), cin0, ptr(x1), cin1, w.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), ptr(y), ptr(yp), N, H, W,
                cinp, cout, coutp, *epi, _stream(x0))
    _build.check(err, f"conv3x3_int8 ({plan.body})")
    conv3x3_int8.launches += 1
    if head is not None:
        return lab
    return (y, yp) if pool else y


conv3x3_int8.launches = 0


# ---------------------------------------------------------------------------
# K2: 2x2/2 transposed conv (replaces ct2x2_int8, ct_up_psrp and ct_psrp)
# ---------------------------------------------------------------------------


def pack_ct2x2_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(cin, cout, 2, 2) int8 (ConvTranspose2d layout) -> K2's weights (nk,
    4*cout, 32) int8, K-contiguous per column (the tensor cores' B
    operand): [j, col, b] = w[32j + b, co, dy, dx] for column col = (2*dy +
    dx)*cout + co; cin zero-padded to nk * 32."""
    cin, cout, kh, kw = w_q.shape
    assert (kh, kw) == (2, 2) and w_q.dtype == torch.int8, w_q.shape
    nk = -(-cin // KCHUNK)
    dense = torch.zeros(nk * KCHUNK, 4 * cout, dtype=torch.int8,
                        device=w_q.device)
    dense[:cin] = w_q.permute(0, 2, 3, 1).reshape(cin, 4 * cout)
    return dense.reshape(nk, KCHUNK, 4 * cout).permute(0, 2, 1).contiguous()


def _ct2x2_dense(w: torch.Tensor, cin: int) -> torch.Tensor:
    """``pack_ct2x2_weights`` -> the (cin, 4*cout) GEMM operand."""
    nk, ncol, _ = w.shape
    return w.permute(0, 2, 1).reshape(nk * KCHUNK, ncol)[:cin]


def unpack_ct2x2_weights(w: torch.Tensor, cin: int) -> torch.Tensor:
    """Inverse of ``pack_ct2x2_weights``: (cin, cout, 2, 2) int8."""
    return _ct2x2_dense(w, cin).reshape(cin, 2, 2, -1).permute(0, 3, 1, 2)


# K2's fixed sizes (csrc/ct2x2_int8.cu): 8 warps a block, each 32 pixels by
# 64 columns (2 m16 by 8 n8 tiles), so a tile of TM pixels and CO_T output
# channels (4*CO_T columns) has TM * CO_T = 32 * 128; ring slots of A chunks
CT_TILES = ((256, 16), (128, 32), (64, 64), (32, 128))
CT_STAGES = 4


def ct2x2_smem(tm: int, co_t: int, nk: int) -> int:
    """Dynamic shared memory of one K2 block (the C side computes the
    same): the block's weights (nk x 4*co_t rows of 32 bytes), the ring
    (CT_STAGES x tm rows of 32 bytes), the output tile (2 x tm rows of
    2*co_t + 16 bytes) and the (scale, bias) pairs of its 4*co_t
    columns."""
    return (nk * 4 * co_t * KCHUNK + CT_STAGES * tm * KCHUNK
            + 2 * tm * (2 * co_t + 16) + 4 * co_t * 8)


class Ct2x2Plan(NamedTuple):
    """K2's launch for one call (``ct2x2_plan``). A block of ``warps``
    warps owns ``co_t`` output channels (all four taps: 4*co_t GEMM
    columns; ``n_co`` channel tiles) and walks the tiles of ``tm``
    consecutive input pixels u = x, x + grid, ... (the grid is
    (``grid``, ``n_co``)); the ``nk`` K chunks (32 channels) of its tiles
    pass through a ring of ``stages`` slots, ``smem`` bytes of dynamic
    shared memory a block, ``blocks_per_sm`` resident. ``loader``:
    "async" (cp.async; cin % 16 == 0, an aligned input) or "gather"
    (byte loads). A refused call (its weights do not fit one block's
    shared memory) has tm = 0."""

    N: int
    H: int
    W: int
    cin: int
    cout: int
    tm: int
    co_t: int
    warps: int
    nk: int
    stages: int
    grid: int
    n_co: int
    loader: str
    blocks_per_sm: int
    smem: int

    @property
    def units(self) -> int:
        return -(-self.N * self.H * self.W // self.tm) if self.tm else 0


def ct2x2_plan_for(N: int, H: int, W: int, cin: int, cout: int, co_t: int,
                   aligned: bool = True, sms: int = H100_SMS,
                   persistent: bool = True) -> Ct2x2Plan:
    """K2's plan at ``co_t`` output channels a block (16, 32, 64 or 128),
    admitted or not (``ct2x2_plan`` chooses). Two resident blocks an SM
    where their shared memory fits (the kernel's __launch_bounds__ holds
    its registers to two: 64 int32 accumulators a thread), else one; a
    persistent grid of that many blocks an SM over the channel tiles, or
    (``persistent=False``) one block a tile."""
    tm = dict((c, t) for t, c in CT_TILES)[co_t]
    nk = -(-cin // KCHUNK)
    smem = ct2x2_smem(tm, co_t, nk)
    per_sm = SM_SMEM // (smem + BLOCK_SMEM_RESERVED)
    loader = "async" if cin % 16 == 0 and aligned else "gather"
    n_co = -(-cout // co_t)
    if per_sm < 1:
        return Ct2x2Plan(N, H, W, cin, cout, 0, co_t, 8, nk, CT_STAGES, 0,
                         n_co, loader, 0, smem)
    per_sm = min(per_sm, 2)
    units = -(-N * H * W // tm)
    grid = units if not persistent else min(
        units, max(1, per_sm * sms // n_co))
    return Ct2x2Plan(N, H, W, cin, cout, tm, co_t, 8, nk, CT_STAGES, grid,
                     n_co, loader, per_sm, smem)


@functools.lru_cache(maxsize=256)
def ct2x2_plan(N: int, H: int, W: int, cin: int, cout: int,
               aligned: bool = True, sms: int = H100_SMS) -> Ct2x2Plan:
    """K2's plan for (N, H, W, cin) -> (N, 2H, 2W, cout). ``aligned``: the
    input pointer is 16-byte aligned; ``sms``: the card's SM count.

    Output channels a block: the widest of 128, 64, 32, 16 that is not
    above cout (rounded up to 16) and lets two blocks share an SM (the
    block keeps cin x 4*co_t weight bytes resident), else the widest for
    one block. At f = 32 that is co_t = cout at ct3 (32: 128-pixel tiles)
    and ct2 (64: 64-pixel tiles), 64 at ct1 and 32 at ct0. The grid is
    persistent: the next tile's chunks are copied while a tile's epilogue
    runs."""
    wide = _round_up(cout, 16)
    fits = [ct2x2_plan_for(N, H, W, cin, cout, c, aligned, sms)
            for t, c in CT_TILES[::-1] if c <= wide]
    for need in (2, 1):
        for plan in fits:
            if plan.blocks_per_sm >= need:
                return plan
    return fits[-1]  # refused (tm = 0)


def ct2x2_int8_reference(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor, *,
                         out_clip: float = 127.0) -> torch.Tensor:
    """Plain version of K2 (any device)."""
    N, H, W, cin = x.shape
    cout = scale.shape[0]
    acc = x.reshape(-1, cin).double() @ _ct2x2_dense(w, cin).double()
    acc = acc.reshape(N, H, W, 2, 2, cout)
    if bias.numel() == 4 * cout:  # per column (2*dy + dx)*cout + co
        bias = bias.reshape(2, 2, cout)
    y = requant_reference(acc, scale, bias, relu=False, out_clip=out_clip)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(N, 2 * H, 2 * W, cout)


@functools.lru_cache(maxsize=16)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ct2x2_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, *, out_clip: float = 127.0) -> torch.Tensor:
    """K2: (N, H, W, cin) int8 -> (N, 2H, 2W, cout) int8 with
    out[n, 2i+dy, 2j+dx, co] = requant(x[n, i, j, :] . w[:, co, dy, dx]),
    no relu, clip +-``out_clip`` (an integer in [0, 127]). w:
    ``pack_ct2x2_weights``; cin must be a multiple of 4. bias: ``cout``
    values, or ``4*cout`` indexed by the column ``(2*dy + dx)*cout + co``
    (a per-tap bias). The launch is ``ct2x2_plan``'s."""
    if x.device.type == "cpu":
        return ct2x2_int8_reference(x, w, scale, bias, out_clip=out_clip)
    dev = x.device
    _check(dev.type == "cuda", f"ct2x2_int8: unsupported device {dev}")
    _check_cuda_int8(x, 4, "ct2x2_int8 input", dev)
    N, H, W, cin = x.shape
    cout = scale.shape[0]
    _check(cin % 4 == 0, f"ct2x2_int8: cin {cin} not a multiple of 4")
    _check_cuda_int8(w, 3, "ct2x2_int8 weights", dev)
    nk = -(-cin // KCHUNK)
    _check(tuple(w.shape) == (nk, 4 * cout, KCHUNK)
           and w.data_ptr() % 16 == 0,
           f"ct2x2_int8: weights {tuple(w.shape)}, expected 16-byte aligned "
           f"{(nk, 4 * cout, KCHUNK)}")
    _check_vec(scale, cout, "ct2x2_int8 scale", dev)
    per_col = bias.numel() == 4 * cout
    _check_vec(bias, 4 * cout if per_col else cout, "ct2x2_int8 bias", dev)
    _check(float(out_clip).is_integer() and 0 <= out_clip <= 127,
           f"ct2x2_int8: out_clip {out_clip}: an integer in [0, 127]")
    plan = ct2x2_plan(N, H, W, cin, cout, x.data_ptr() % 16 == 0,
                      _sm_count(dev.index if dev.index is not None
                                else torch.cuda.current_device()))
    _check(plan.tm > 0, f"ct2x2_int8: no launch for cin {cin}, cout "
           f"{cout}: the weights need {plan.smem} bytes of shared memory")
    y = torch.empty((N, 2 * H, 2 * W, cout), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_ct2x2_int8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            int(per_col), float(out_clip), y.data_ptr(), N, H, W, cin, cout,
            plan.tm, plan.co_t, plan.nk, plan.stages, plan.grid,
            int(plan.loader == "gather"), plan.smem, _stream(x))
    _build.check(err, "ct2x2_int8")
    ct2x2_int8.launches += 1
    return y


ct2x2_int8.launches = 0


# ---------------------------------------------------------------------------
# K11: 2x2/2 max-pool (replaces pool2x2_int8 on the TPU)
# ---------------------------------------------------------------------------


def pool2x2_int8_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K11 (any device): a reshape-max."""
    n, h, w, c = x.shape
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def pool2x2_int8(x: torch.Tensor) -> torch.Tensor:
    """K11: (N, H, W, C) int8 -> (N, H/2, W/2, C) int8, the max of each
    2x2 window; H and W must be even (the TPU kernel asserts it too)."""
    _check(x.dim() == 4 and x.shape[1] % 2 == 0 and x.shape[2] % 2 == 0,
           f"pool2x2_int8: expected (N, H, W, C) with even H, W, got "
           f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return pool2x2_int8_reference(x)
    dev = x.device
    _check(dev.type == "cuda", f"pool2x2_int8: unsupported device {dev}")
    _check_cuda_int8(x, 4, "pool2x2_int8 input", dev)
    N, H, W, C = x.shape
    y = torch.empty((N, H // 2, W // 2, C), dtype=torch.int8, device=dev)
    # the widest vector that divides C and both pointers' alignment
    vec = next(v for v in (16, 8, 4, 1) if C % v == 0
               and x.data_ptr() % v == 0 and y.data_ptr() % v == 0)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_pool2x2_int8(
            x.data_ptr(), y.data_ptr(), N, H, W, C, vec, _stream(x))
    _build.check(err, "pool2x2_int8")
    pool2x2_int8.launches += 1
    return y


pool2x2_int8.launches = 0
