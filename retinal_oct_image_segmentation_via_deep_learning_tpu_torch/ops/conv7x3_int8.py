"""K7: ReLayNet's int8 KHx3 conv with a PReLU requant and an optional fused
2x2/2 index max-pool.

One kernel (``csrc/conv7x3_int8.cu``) for the two TPU kernels of ReLayNet's
served graph, ``ops/pallas_conv_psrp7.py:conv7x3_psrp`` (blocks b1..b6; the
decoders' ``cat([skip, unpooled])`` is folded into the kernel, which reads
both inputs) and ``stem7_psrp`` (the Cin=1 stem). Their PSRP packings fill
the TPU's lanes and are not part of the function: here activations are
plain NHWC int8.

Per output: the int32 accumulator of a KHx3 stride-1 'same' conv (KH odd:
3, 5 or 7), then ``v = fmaf(float(acc), scale[co], bias[co])``, the PReLU
``v >= 0 ? v : alpha*v`` with one float32 slope, round-half-even, clip to
[-127, 127], int8. ``scale = (s_in*s_w)/s_out`` and ``bias = b/s_out``.
With ``pool=True`` it also returns the 2x2/2 max-pool of that int8 output
and the window indices (int8, flat ``dy*2 + dx``, the first maximum), the
indices ``ops/pooling.max_unpool`` replays.

The wrapper runs the CUDA kernel for a CUDA tensor and the plain version
(``conv7x3_int8_reference``, float64 products and the FMA emulated in
float64, then rounded once to float32) only for a CPU tensor. Weights are
packed once, at quantize time (``pack_conv7x3_weights``), and each call's
launch (tile, ring stages, shared memory, loader) is ``conv7x3_plan``'s.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_int8 import (
    _check,
    _check_cuda_int8,
    _check_vec,
    _round_up,
    _stream,
    conv3x3_chunk,
)
from .pooling import max_pool_argmax

KERNEL_HEIGHTS = (3, 5, 7)
# the kernel's fixed sizes (csrc/conv7x3_int8.cu): an output tile of ROWS x
# COLS pixels for THREADS threads (8 warps, 4 tile rows each; the stem's
# tile STEM_ROWS x COLS, 2 rows a warp), K chunks of KCHUNK bytes a pixel,
# and the shared memory a block may use; the card the stem's persistent
# grid is planned for (an H100 SXM: 132 SMs, two stem blocks each)
ROWS, STEM_ROWS, COLS, THREADS, KCHUNK = 32, 16, 16, 256, 32
SMEM_MAX = 232448
_SMS, _STEM_BLOCKS_PER_SM = 132, 2
# loader kinds, as the C entry point numbers them
LOADERS = ("async", "gather", "im2col_async", "im2col_gather")


def pack_conv7x3_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(cout, cin, kh, 3) int8 -> the kernel's weights, zero-padded, coutp
    = cout padded to a multiple of 32:

    * cin > 4: (nk, kh*3, coutp, 32), K-contiguous per output channel (the
      tensor cores' B operand): [j, t, co, b] = w[co, 32j + b, t // 3,
      t % 3], cin padded to nk * 32 channels;
    * cin <= 4 (the stem, taps folded into K): (kh*3, 1, coutp, 4), word
      [t, 0, co] = w[co, 0..3, t // 3, t % 3]; the kernel places it at
      bytes 4t..4t+3 of the output channel's K row."""
    cout, cin, kh, kw = w_q.shape
    assert kh in KERNEL_HEIGHTS and kw == 3 and w_q.dtype == torch.int8, \
        w_q.shape
    cinp, coutp = conv3x3_chunk(cin), _round_up(cout, 32)
    dense = torch.zeros(kh * 3, cinp, coutp, dtype=torch.int8,
                        device=w_q.device)
    dense[:, :cin, :cout] = w_q.permute(2, 3, 1, 0).reshape(kh * 3, cin, cout)
    if cinp == 4:
        return dense.permute(0, 2, 1).reshape(kh * 3, 1, coutp, 4) \
            .contiguous()
    return dense.reshape(kh * 3, cinp // KCHUNK, KCHUNK, coutp) \
        .permute(1, 0, 3, 2).contiguous()


def _kh(w: torch.Tensor) -> int:
    """The window height of packed weights."""
    return (w.shape[0] if w.shape[-1] == 4 else w.shape[1]) // 3


def unpack_conv7x3_weights(w: torch.Tensor, cin: int,
                           cout: int) -> torch.Tensor:
    """Inverse of ``pack_conv7x3_weights``: (cout, cin, kh, 3) int8."""
    kh = _kh(w)
    if w.shape[-1] == 4:
        dense = w.reshape(kh * 3, -1, 4).permute(0, 2, 1)
    else:
        nk, taps, coutp, _ = w.shape
        dense = w.permute(1, 0, 3, 2).reshape(taps, nk * KCHUNK, coutp)
    dense = dense[:, :cin, :cout]
    return dense.reshape(kh, 3, cin, cout).permute(3, 2, 0, 1)


def packed_shape(cin: int, cout: int, kh: int) -> tuple[int, int, int, int]:
    """The shape ``pack_conv7x3_weights`` gives (cout, cin, kh, 3)."""
    coutp = _round_up(cout, 32)
    if conv3x3_chunk(cin) == 4:
        return (kh * 3, 1, coutp, 4)
    return (conv3x3_chunk(cin) // KCHUNK, kh * 3, coutp, KCHUNK)


class Conv7x3Plan(NamedTuple):
    """K7's launch for one call (``conv7x3_plan``). Tiles are ``rows`` x
    COLS pixels. cin > 4: the grid is (blocks = the tiles of an image,
    coutp / co_t, N), and a block runs the nk K chunks of its tile through a
    ring of ``stages`` shared-memory slots. cin <= 4 (im2col): the grid is
    (blocks, coutp / co_t), and block b walks the tiles b, b + blocks, ...
    of all N images (tile u: image u // tiles). ``smem``: bytes of dynamic
    shared memory a block."""

    N: int
    H: int
    W: int
    cin0: int
    cin1: int
    cout: int
    kh: int
    pool: bool
    coutp: int
    co_t: int
    nk: int
    taps: int
    stages: int
    loader: str
    rows: int
    blocks: int
    smem: int

    @property
    def tiles(self) -> int:
        """Tiles of one image."""
        return -(-self.H // self.rows) * -(-self.W // COLS)


def _smem(kh: int, co_t: int, nk: int, taps: int, stages: int,
          im2col: bool) -> int:
    """Shared memory of one block (the C side computes the same)."""
    rows = STEM_ROWS if im2col else ROWS
    hr = rows + kh - 1
    out = rows * COLS * (co_t + 16)  # the epilogue's int8 tile, padded rows
    if im2col:  # the tile, the weights, the word halo, the staged rows
        return out + nk * co_t * KCHUNK + hr * (COLS + 2) * 4 + hr * 48 * 4
    return max(out, stages * (hr * (COLS + 2) * KCHUNK
                              + taps * co_t * KCHUNK))


@functools.lru_cache(maxsize=256)
def conv7x3_plan(N: int, H: int, W: int, cins: tuple, cout: int, kh: int,
                 pool: bool, aligned: bool = True) -> Conv7x3Plan:
    """K7's launch plan for inputs of ``cins`` channels (one or two), H x W,
    cout outputs, a kh x 3 window. ``aligned``: every input pointer is
    16-byte aligned. Output channels a block: 64 where coutp allows, else
    32. Loader: ``async`` (cp.async 16-byte copies, zero-filled outside the
    image) when every input's channel count is a multiple of 32, else
    ``gather`` (bytes gathered into the same layout); for cin <= 4 the
    im2col loaders, ``im2col_async`` for one input whose image rows are
    whole 16-byte units. Stages: 3 where there are 3 or more chunks and
    they fit, else 2. The stem's grid: as many blocks as the card holds at
    once (2 an SM), at most one a tile."""
    cins = tuple(cins)
    cin0, cin1 = cins[0], (cins[1] if len(cins) > 1 else 0)
    cin = cin0 + cin1
    coutp = _round_up(cout, 32)
    if conv3x3_chunk(cin) == 4:  # im2col: kh*3 taps x 4 bytes in 32-byte chunks
        nk, taps = -(-kh * 3 * 4 // KCHUNK), 1
    else:
        nk, taps = conv3x3_chunk(cin) // KCHUNK, kh * 3
    co_t = 64 if coutp % 64 == 0 else 32
    im2col = taps == 1
    if im2col:
        loader = "im2col_async" if (aligned and cin1 == 0
                                    and (W * cin0) % 16 == 0) \
            else "im2col_gather"
        stages = 1
    else:
        loader = "async" if (aligned and cin0 % 32 == 0
                             and cin1 % 32 == 0) else "gather"
        stages = 3 if nk >= 3 and _smem(kh, co_t, nk, taps, 3, False) \
            <= SMEM_MAX else 2
    rows = STEM_ROWS if im2col else ROWS
    tiles = -(-H // rows) * -(-W // COLS)
    blocks = min(N * tiles, _SMS * _STEM_BLOCKS_PER_SM) if im2col else tiles
    return Conv7x3Plan(N, H, W, cin0, cin1, cout, kh, bool(pool), coutp,
                       co_t, nk, taps, stages, loader, rows, blocks, _smem(kh, co_t, nk, taps, stages, im2col))


def _alpha32(alpha) -> float:
    """The PReLU slope as the float32 value the kernel takes."""
    return torch.tensor(float(alpha), dtype=torch.float32).item()


def conv7x3_int8_reference(inputs, w: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor, alpha, *, pool: bool = False):
    """Plain version of K7 (any device)."""
    inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) else (inputs,)
    x = torch.cat(inputs, dim=-1) if len(inputs) > 1 else inputs[0]
    cout = scale.shape[0]
    wd = unpack_conv7x3_weights(w, x.shape[-1], cout).double()
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(), wd,
                   padding=((wd.shape[2] - 1) // 2, 1)).permute(0, 2, 3, 1)
    v = (acc.float().double() * scale.double() + bias.double()).float()
    v = torch.where(v >= 0, v, v * _alpha32(alpha))
    y = torch.round(v).clamp(-127, 127).to(torch.int8).contiguous()
    if not pool:
        return y
    pooled, idx = max_pool_argmax(y)
    return y, pooled.contiguous(), idx.to(torch.int8).contiguous()


def conv7x3_int8(inputs, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, alpha, *, pool: bool = False):
    """K7: int8 KHx3 'same' conv + PReLU requant over the channel concat of
    1-2 NHWC inputs.

    inputs: one (N, H, W, C) int8 tensor or a tuple of two (no ``torch.cat``
    is made). w: ``pack_conv7x3_weights`` of the (cout, sum C, kh, 3)
    weights. alpha: the PReLU slope (a float or a 0-d tensor). Returns
    (N, H, W, cout) int8; with ``pool=True`` also the (N, H/2, W/2, cout)
    pooled int8 tensor and its int8 window indices.
    """
    inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) else (inputs,)
    x0 = inputs[0]
    if x0.device.type == "cpu":
        return conv7x3_int8_reference(inputs, w, scale, bias, alpha,
                                      pool=pool)
    dev = x0.device
    _check(dev.type == "cuda", f"conv7x3_int8: unsupported device {dev}")
    _check(1 <= len(inputs) <= 2, "conv7x3_int8: one or two inputs")
    for k, t in enumerate(inputs):
        _check_cuda_int8(t, 4, f"conv7x3_int8 input {k}", dev)
        _check(t.shape[:3] == x0.shape[:3],
               "conv7x3_int8: input shapes "
               f"{[tuple(t.shape) for t in inputs]}")
    N, H, W, cin0 = x0.shape
    cin1 = inputs[1].shape[-1] if len(inputs) > 1 else 0
    cout = scale.shape[0]
    _check_cuda_int8(w, 4, "conv7x3_int8 weights", dev)
    kh = _kh(w)
    _check(kh in KERNEL_HEIGHTS
           and tuple(w.shape) == packed_shape(cin0 + cin1, cout, kh),
           f"conv7x3_int8: weights {tuple(w.shape)}, expected "
           f"pack_conv7x3_weights of ({cout}, {cin0 + cin1}, kh, 3) with kh "
           f"in {KERNEL_HEIGHTS}")
    _check_vec(scale, cout, "conv7x3_int8 scale", dev)
    _check_vec(bias, cout, "conv7x3_int8 bias", dev)
    _check(not pool or (H % 2 == 0 and W % 2 == 0),
           f"conv7x3_int8: pool needs even H, W, got {(H, W)}")
    y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
    yp = yi = None
    if pool:
        yp, yi = (torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8,
                              device=dev) for _ in range(2))
    x1 = inputs[1] if len(inputs) > 1 else None
    plan = conv7x3_plan(N, H, W, tuple(t.shape[-1] for t in inputs), cout, kh,
                        pool, all(t.data_ptr() % 16 == 0 for t in inputs))
    with torch.cuda.device(dev):
        err = _build.lib().octseg_conv7x3_int8(
            x0.data_ptr(), cin0, x1.data_ptr() if x1 is not None else None,
            cin1, w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            _alpha32(alpha), y.data_ptr(), yp.data_ptr() if pool else None,
            yi.data_ptr() if pool else None, N, H, W, cout, plan.coutp, kh,
            plan.co_t, plan.nk, plan.stages, plan.blocks,
            LOADERS.index(plan.loader),
            plan.smem, _stream(x0))
    _build.check(err, "conv7x3_int8")
    conv7x3_int8.launches += 1
    return (y, yp, yi) if pool else y


conv7x3_int8.launches = 0
