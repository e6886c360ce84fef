"""bf16 3x3 training convolution: K4 (forward and dgrad) and K5 (wgrad).

The counterpart of the JAX package's ``ops/pallas_conv_bf16.py``
(``conv3x3_psrp_bf16`` and its custom VJP). The PSRP packing and the banded
weight matrices there are the TPU's lane layout; here activations stay NHWC
and the weights (3, 3, cin, cout), and K5 writes the (3, 3, cin, cout)
gradient directly, which is the function the band fold computed.

* ``conv3x3_bf16(x, w)``: differentiable 3x3 'same' stride-1 conv, x (N, H,
  W, cin) bf16, w (3, 3, cin, cout) bf16 -> (N, H, W, cout) bf16, fp32
  accumulation rounded once to bf16.
* backward: dy is rounded to bf16; dx is K4 on dy with ``flip_w(w)``; dw is
  K5, in fp32, then cast to the dtype of w.

Each wrapper runs its CUDA kernel (``csrc/conv3x3_bf16.cu``) for a CUDA
tensor and its plain PyTorch version (``*_reference``) only for a CPU
tensor. K4 has two bodies: ``fwd_plan`` puts a call on the ``mma.sync``
implicit GEMM where its channels and pointers allow, with the weights
packed per call (``pack_conv3x3_bf16_weights``), and on the WMMA body
otherwise. The plain versions compute in float64 and round as the kernels do:
to float32 (the accumulator), then, for K4, to bf16. Where every fp32
partial sum is exact (small integer inputs) kernel and plain version are
bit-equal; on random data K4 may differ by one bf16 ulp on a few elements.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build
from .conv_int8 import _check, _round_up, _stream

# K5's fixed sizes (csrc/conv3x3_bf16.cu): output channels a block, widest
# column tile, tallest band; and the card it is planned for (an H100 SXM:
# 132 SMs, two K5 blocks each)
_CO_T, _TWK_MAX, _R_MAX = 32, 128, 64
_SMS, _BLOCKS_PER_SM = 132, 2
# K4's mma.sync body (csrc/conv3x3_bf16.cu:conv3x3_bf16_mma): an output
# tile of ROWS x COLS pixels for 256 threads (8 warps, 4 tile rows = 4
# m16 tiles each), K chunks of KCHUNK input channels (32 bytes a pixel, the
# MMA's k), 32 or 64 output channels a block; the WMMA body's tile and
# static shared memory; an H100 SM's shared memory, of which each resident
# block takes 1 KB more than it asks for
ROWS, COLS, KCHUNK = 32, 16, 16
_WMMA_ROWS, _WMMA_SMEM = 8, 31360
SM_SMEM, BLOCK_SMEM_RESERVED = 233472, 1024


def flip_w(w: torch.Tensor) -> torch.Tensor:
    """Input-gradient weights: spatial 180-degree rotation and in/out
    transpose, (3, 3, cin, cout) -> (3, 3, cout, cin)."""
    return w.flip(0, 1).transpose(2, 3).contiguous()


def _to_bf16(t64: torch.Tensor) -> torch.Tensor:
    return t64.float().to(torch.bfloat16)


def conv3x3_bf16_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 (any device)."""
    y = F.conv2d(x.permute(0, 3, 1, 2).double(),
                 w.permute(3, 2, 0, 1).double(), padding=1)
    return _to_bf16(y.permute(0, 2, 3, 1)).contiguous()


def conv3x3_bf16_dgrad_reference(dy: torch.Tensor,
                                 w: torch.Tensor) -> torch.Tensor:
    """Plain version of K4 as the dgrad: the transposed convolution of dy
    with w (independent of ``flip_w``)."""
    dx = F.conv_transpose2d(dy.permute(0, 3, 1, 2).double(),
                            w.permute(3, 2, 0, 1).double(), padding=1)
    return _to_bf16(dx.permute(0, 2, 3, 1)).contiguous()


def conv3x3_bf16_wgrad_reference(x: torch.Tensor,
                                 dy: torch.Tensor) -> torch.Tensor:
    """Plain version of K5: (3, 3, cin, cout) float32, one float64 product
    of the shifted input with dy per tap."""
    N, H, W, cin = x.shape
    cout = dy.shape[-1]
    xp = F.pad(x.double(), (0, 0, 1, 1, 1, 1))
    d = dy.double().reshape(-1, cout)
    taps = [xp[:, ky:ky + H, kx:kx + W].reshape(-1, cin).t() @ d
            for ky in range(3) for kx in range(3)]
    return torch.stack(taps).reshape(3, 3, cin, cout).float()


def _check_bf16(t: torch.Tensor, ndim: int, what: str,
                device: torch.device) -> None:
    _check(t.device == device, f"{what}: on {t.device}, expected {device}")
    _check(t.dtype == torch.bfloat16, f"{what}: dtype {t.dtype}, expected "
           "bfloat16")
    _check(t.dim() == ndim, f"{what}: {t.dim()}-D, expected {ndim}-D")
    _check(t.is_contiguous(), f"{what}: not contiguous")


def pack_conv3x3_bf16_weights(w: torch.Tensor, co_t: int = 32) -> torch.Tensor:
    """(3, 3, cin, cout) bf16 -> the mma.sync body's weights, (nk, 9,
    coutp, 16) with [j, t, co, b] = w[t // 3, t % 3, 16j + b, co]: K
    contiguous per output channel (the MMA's B operand, 32 bytes a row),
    zero-padded to nk = ceil(cin / 16) chunks and coutp = cout rounded up
    to ``co_t``."""
    _, _, cin, cout = w.shape
    nk, coutp = -(-cin // KCHUNK), _round_up(cout, co_t)
    dense = w.reshape(9, cin, cout)
    if (nk * KCHUNK, coutp) != (cin, cout):
        dense = F.pad(dense, (0, coutp - cout, 0, nk * KCHUNK - cin))
    return dense.reshape(9, nk, KCHUNK, coutp).permute(1, 0, 3, 2) \
        .contiguous()


def unpack_conv3x3_bf16_weights(wk: torch.Tensor, cin: int,
                                cout: int) -> torch.Tensor:
    """Inverse of ``pack_conv3x3_bf16_weights``: (3, 3, cin, cout)."""
    nk, taps, coutp, kc = wk.shape
    dense = wk.permute(1, 0, 3, 2).reshape(taps, nk * kc, coutp)
    return dense[:, :cin, :cout].reshape(3, 3, cin, cout)


class FwdPlan(NamedTuple):
    """K4's launch for one call (``fwd_plan``). The output is cut into
    units of ``rows`` x ``cols`` pixels by ``co_t`` output channels, one
    block a unit, numbered u = ((n * tiles_y + ty) * tiles_x + tx) * n_co
    + channel tile: the grid is (tiles of an image x n_co, N) with the
    channel tile fastest, so the blocks of one tile's channel tiles run
    side by side and the second read of its input comes from L2. ``body``
    "mma": the K chunks of 16 input channels pass through a ring of
    ``stages`` shared-memory slots, ``smem`` bytes of dynamic shared memory
    a block, ``blocks_per_sm`` resident blocks (the kernel's
    ``__launch_bounds__``). "wmma": the WMMA body, 8 x 16 tiles, ``smem``
    bytes of static shared memory."""

    N: int
    H: int
    W: int
    cin: int
    cout: int
    body: str
    rows: int
    cols: int
    co_t: int
    coutp: int
    nk: int
    stages: int
    blocks_per_sm: int
    smem: int

    @property
    def tiles_y(self) -> int:
        return -(-self.H // self.rows)

    @property
    def tiles_x(self) -> int:
        return -(-self.W // self.cols)

    @property
    def n_co(self) -> int:
        return self.coutp // self.co_t

    @property
    def units(self) -> int:
        return self.N * self.tiles_y * self.tiles_x * self.n_co


def mma_smem(co_t: int, stages: int) -> int:
    """Dynamic shared memory of one mma.sync block (the C side computes
    the same): ``stages`` slots of a (ROWS+2) x (COLS+2) halo chunk and
    the chunk's 9 x co_t weight rows, 32 bytes each; the epilogue's bf16
    tile (rows of co_t channels + 16 bytes) reuses the ring."""
    ring = stages * ((ROWS + 2) * (COLS + 2) + 9 * co_t) * 2 * KCHUNK
    return max(ring, ROWS * COLS * (2 * co_t + 16))


def plan_for(N: int, H: int, W: int, cin: int, cout: int, body: str,
             co_t: int = 32) -> FwdPlan:
    """The plan of one body, admitted or not (``fwd_plan`` chooses). The
    mma.sync body: three ring slots where there are two chunks or more
    (a tile's first two chunks in flight from its start), two blocks an
    SM at co_t 32 (2 x 86,400 bytes of shared memory, and the 1 KB each
    block reserves, fit an SM's 228 KB), one at co_t 64."""
    nk = -(-cin // KCHUNK)
    if body == "wmma":
        return FwdPlan(N, H, W, cin, cout, "wmma", _WMMA_ROWS, COLS, 32,
                       _round_up(cout, 32), nk, 1, 1, _WMMA_SMEM)
    stages = 3 if nk >= 2 else 2
    return FwdPlan(N, H, W, cin, cout, "mma", ROWS, COLS, co_t,
                   _round_up(cout, co_t), nk, stages, 2 if co_t == 32 else 1,
                   mma_smem(co_t, stages))


@functools.lru_cache(maxsize=256)
def fwd_plan(N: int, H: int, W: int, cin: int, cout: int,
             aligned: bool = True) -> FwdPlan:
    """K4's plan for x (N, H, W, cin) and cout outputs. ``aligned``: x is
    16-byte aligned (the weights and y are fresh tensors). The mma.sync
    body takes the call when cin % 16 == 0 (whole 32-byte K chunks, copied
    16 bytes at a time), cout % 8 == 0 (16-byte stores) and x is aligned,
    with 32 output channels a block; every other call stays on the WMMA
    body. At all 17 convs of the U-Net, forward and dgrad, the mma.sync
    body was 4-5x faster than WMMA on the card (``k4_probe.py``, PERF.md
    section 6), so the plan admits them all.

    Overlap: a tile has only 2-4 K chunks x 9 taps, too short a loop for a
    ring inside one block to hide its first chunk's copy. It comes from a
    second resident block: at 32 output channels a block the fp32
    accumulators are 64 registers a thread, so two 256-thread blocks share
    an SM (``__launch_bounds__(256, 2)``), and while one waits for its
    copies or stores its tile the other multiplies. (A persistent grid
    whose ring ran across tiles was slower: PERF.md section 6.)"""
    if cin % KCHUNK == 0 and cout % 8 == 0 and aligned:
        return plan_for(N, H, W, cin, cout, "mma")
    return plan_for(N, H, W, cin, cout, "wmma")


def _launch_fwd(x: torch.Tensor, w: torch.Tensor,
                plan: FwdPlan) -> torch.Tensor:
    """One launch of K4's body ``plan.body`` on checked CUDA tensors."""
    N, H, W, cin = x.shape
    cout = w.shape[-1]
    y = torch.empty((N, H, W, cout), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        if plan.body == "mma":
            wk = pack_conv3x3_bf16_weights(w, plan.co_t)
            err = _build.lib().octseg_conv3x3_bf16_mma(
                x.data_ptr(), wk.data_ptr(), y.data_ptr(), N, H, W, cin, cout,
                plan.coutp, plan.co_t, plan.nk, plan.stages, plan.smem,
                _stream(x))
        else:
            err = _build.lib().octseg_conv3x3_bf16(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, cin, cout,
                _stream(x))
    _build.check(err, f"conv3x3_bf16 ({plan.body})")
    return y


def conv3x3_bf16_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4: (N, H, W, cin) bf16 * (3, 3, cin, cout) bf16 -> (N, H, W, cout)
    bf16. Forward, and the dgrad on ``flip_w`` weights. The body is
    ``fwd_plan``'s."""
    if x.device.type == "cpu":
        return conv3x3_bf16_reference(x, w)
    dev = x.device
    _check(dev.type == "cuda", f"conv3x3_bf16: unsupported device {dev}")
    _check_bf16(x, 4, "conv3x3_bf16 input", dev)
    _check_bf16(w, 4, "conv3x3_bf16 weights", dev)
    N, H, W, cin = x.shape
    cout = w.shape[-1]
    _check(tuple(w.shape) == (3, 3, cin, cout),
           f"conv3x3_bf16: weights {tuple(w.shape)} for input {tuple(x.shape)}")
    y = _launch_fwd(x, w, fwd_plan(N, H, W, cin, cout, x.data_ptr() % 16 == 0))
    conv3x3_bf16_fwd.launches += 1
    return y


conv3x3_bf16_fwd.launches = 0


class WgradPlan(NamedTuple):
    """K5's work plan for one call (``wgrad_plan``). The grid is (G, n_ci,
    n_co); a band ("unit") is R output rows x ``twk`` columns of one image,
    numbered u = (n * nbands + band) * nct + column tile, and block g takes
    the units g, g+G, g+2G, ... in that order, for one channel tile of
    ``ci_t`` input and ``co_t`` output channels."""

    N: int
    H: int
    W: int
    cin: int
    cout: int
    G: int
    R: int
    twk: int
    ci_t: int
    co_t: int

    @property
    def nbands(self) -> int:
        return -(-self.H // self.R)

    @property
    def nct(self) -> int:
        return -(-self.W // self.twk)

    @property
    def units(self) -> int:
        return self.N * self.nbands * self.nct

    @property
    def n_ci(self) -> int:
        return -(-self.cin // self.ci_t)

    @property
    def n_co(self) -> int:
        return -(-self.cout // self.co_t)

    def order(self, g: int) -> list[tuple[int, int, int]]:
        """Block g's bands in the order it walks them: (n, first row, first
        column)."""
        out = []
        for u in range(g, self.units, self.G):
            nb, ct = divmod(u, self.nct)
            n, band = divmod(nb, self.nbands)
            out.append((n, band * self.R, ct * self.twk))
        return out

    def reads(self) -> tuple[float, float]:
        """How many times the kernel reads each element of x and of dy from
        device memory: the in-image part of every x row segment (rows y0-1
        .. y0+R, columns x0-1 .. x0+twk) and dy row segment it copies, over
        all blocks and channel tiles, divided by the elements of x and dy."""
        xs = ds = 0
        for g in range(self.G):
            for n, y0, x0 in self.order(g):
                rows = min(self.R, self.H - y0)
                xrows = min(self.H, y0 + rows + 1) - max(0, y0 - 1)
                xcols = min(self.W, x0 + self.twk + 1) - max(0, x0 - 1)
                xs += xrows * xcols
                ds += rows * min(self.twk, self.W - x0)
        pixels = self.N * self.H * self.W
        return xs * self.n_co / pixels, ds * self.n_ci / pixels


@functools.lru_cache(maxsize=64)
def wgrad_plan(N: int, H: int, W: int, cin: int, cout: int) -> WgradPlan:
    """K5's plan for x (N, H, W, cin) and dy (N, H, W, cout). Column tiles
    of up to 128 pixels; the channel tile all of cin up to 64 (16, 32 or 64
    channels) by 32 output channels; bands of 64, 32, 16 or 8 rows, the
    tallest of those that give the shortest block (waves of the grid over
    the 132 x 2 block slots of an H100, times the bands a block walks, times
    R); G as few blocks per channel tile as keep that length."""
    twk = min(_TWK_MAX, _round_up(W, 16))
    ci_t = 16 if cin <= 16 else 32 if cin <= 32 else 64
    tiles = -(-cin // ci_t) * -(-cout // _CO_T)
    nct = -(-W // twk)
    slots = _BLOCKS_PER_SM * _SMS
    g_max = max(1, slots // tiles)

    def grid(r):
        units = N * -(-H // r) * nct
        per_block = -(-units // g_max)  # bands a block walks
        g = -(-units // per_block)
        return -(-g * tiles // slots) * per_block * r, g

    rows = [min(H, _R_MAX)] + [r for r in (32, 16, 8) if r < min(H, _R_MAX)]
    R = min(rows, key=lambda r: (grid(r)[0], -r))
    return WgradPlan(N, H, W, cin, cout, grid(R)[1], R, twk, ci_t, _CO_T)


def pad_channels(t: torch.Tensor) -> torch.Tensor:
    """``t`` (..., C) with C zero-padded to a multiple of 8, in a fresh
    (16-byte aligned) tensor where C needs padding or ``t`` is not 16-byte
    aligned; else ``t`` itself. Zero channels add exact zeros to K5's
    sums."""
    c = t.shape[-1]
    if c % 8:
        return F.pad(t, (0, _round_up(c, 8) - c))
    return t if t.data_ptr() % 16 == 0 else t.clone()


def conv3x3_bf16_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K5: dW[ky, kx, ci, co] = sum over n, h, w of x[n, h+ky-1, w+kx-1, ci]
    * dy[n, h, w, co]; (3, 3, cin, cout) float32. On the card K5 runs on
    ``pad_channels`` of x and dy, with the plan of ``wgrad_plan``, and dW is
    sliced back to cin x cout."""
    if x.device.type == "cpu":
        return conv3x3_bf16_wgrad_reference(x, dy)
    dev = x.device
    _check(dev.type == "cuda", f"conv3x3_bf16_wgrad: unsupported device {dev}")
    _check_bf16(x, 4, "conv3x3_bf16_wgrad input", dev)
    _check_bf16(dy, 4, "conv3x3_bf16_wgrad dy", dev)
    N, H, W, cin = x.shape
    cout = dy.shape[-1]
    _check(tuple(dy.shape[:3]) == (N, H, W),
           f"conv3x3_bf16_wgrad: dy {tuple(dy.shape)} for input "
           f"{tuple(x.shape)}")
    xk, dk = pad_channels(x), pad_channels(dy)
    plan = wgrad_plan(N, H, W, xk.shape[-1], dk.shape[-1])
    partial = torch.empty((plan.G, 9, plan.n_ci * plan.ci_t,
                           plan.n_co * plan.co_t), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((3, 3, plan.cin, plan.cout), dtype=torch.float32,
                     device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_conv3x3_bf16_wgrad(
            xk.data_ptr(), dk.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            N, H, W, plan.cin, plan.cout, plan.G, plan.R, plan.twk,
            plan.ci_t, _stream(x))
    _build.check(err, "conv3x3_bf16_wgrad")
    conv3x3_bf16_wgrad.launches += 1
    if (plan.cin, plan.cout) != (cin, cout):
        dw = dw[..., :cin, :cout].contiguous()
    return dw


conv3x3_bf16_wgrad.launches = 0


class _Conv3x3BF16(torch.autograd.Function):
    """``_conv_bwd_rule`` of the JAX package: dy to bf16, dx by K4 on the
    flipped weights, dw by K5 cast to the dtype of w. The kernels are
    looked up by name at call time."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3_bf16_fwd(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(torch.bfloat16).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3x3_bf16_fwd(dy, flip_w(w))
        if ctx.needs_input_grad[1]:
            dw = conv3x3_bf16_wgrad(x, dy).to(w.dtype)
        return dx, dw


def conv3x3_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable bf16 3x3 'same' conv on NHWC (see the module doc)."""
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError(f"conv3x3_bf16: bf16 input and weights, got "
                         f"{x.dtype} and {w.dtype}")
    return _Conv3x3BF16.apply(x.contiguous(), w.contiguous())
