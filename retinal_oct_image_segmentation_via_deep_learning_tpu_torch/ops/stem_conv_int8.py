"""K10: the fused stem of the served U-Net (stem conv, blk0_conv1, pool).

Replaces the TPU kernel ``ops/pallas_conv_psrp.py:stem_conv_psrp``. One
launch computes what K1 computes in two: the quantized 1-channel image
through the stem 3x3 conv (1 -> c1) and its requant, then blk0_conv1 (c1 ->
cout) and its requant, returning the full-resolution output (the enc0 skip)
and its 2x2/2 max-pool. The int8 stem activation stays in shared memory.
The arithmetic is K1's: ``fmaf(float(acc), scale, bias)``, relu,
round-half-even, clip to +-127, and conv1 zero-pads the int8 stem
activation (a halo pixel outside the image is 0, not the stem of a
zero-padded image).

The wrapper runs the CUDA kernel (``csrc/stem_conv_int8.cu``) for a CUDA
tensor, on the body ``stem_conv_plan`` chooses, and the plain version (two
calls of K1's plain version) only for a CPU tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from . import _build
from .conv_int8 import (
    BLOCK_SMEM_RESERVED,
    H100_SMS,
    KCHUNK,
    SM_SMEM,
    STEM_K,
    _check,
    _check_cuda_int8,
    _check_vec,
    _round_up,
    _sm_count,
    _stream,
    conv3x3_chunk,
    conv3x3_int8_reference,
    mma_weights_from_dp4a,
    stem_weights_from_dp4a,
)

MAX_C1 = 32
# the mma.sync body's fixed sizes (csrc/stem_conv_int8.cu): steps of
# MMA_ROWS output rows (a warp's tile: MMA_ROWS x MMA_COLS pixels, the
# block's 8 warps side by side along the row), c1 = cout = MMA_C, a ring
# of MMA_ROWS + 2 stem rows of W + 2 pixels, image rows padded by IMG_PAD
# zero bytes on either side
MMA_ROWS, MMA_COLS, MMA_C, IMG_PAD = 4, 16, KCHUNK, 16
RING = MMA_ROWS + 2


def stem_mma_smem(W: int) -> int:
    """Dynamic shared memory of one mma.sync block (the C side computes
    the same): the ring of stem rows ((W + 2) pixels x 32 bytes each),
    conv1's weights (9 taps x 32 x 32 bytes), the image rows a band's first
    step reads (RING + 2 rows of W + 2*IMG_PAD bytes), the two
    epilogues' scales and biases (4 x 32 floats) and the stem's weights
    (32 x 16 bytes)."""
    return (RING * (W + 2) * MMA_C + 9 * MMA_C * MMA_C
            + (RING + 2) * (W + 2 * IMG_PAD) + 4 * MMA_C * 4
            + MMA_C * STEM_K)


class StemConvPlan(NamedTuple):
    """K10's launch for one call (``stem_conv_plan``). ``body`` "mma": the
    output is cut into units of ``band`` rows of one image (whole rows),
    numbered u = n * bands + band index and walked by a persistent grid
    of ``grid`` blocks (block b takes u = b, b + grid, ...), each unit in
    steps of MMA_ROWS rows; ``smem`` bytes of dynamic shared memory a
    block, ``blocks_per_sm`` resident. ``body`` "dp4a": the first design
    (16 x 16 tiles, 32 output channels a block, static shared memory); the
    other fields are 0."""

    N: int
    H: int
    W: int
    c1: int
    cout: int
    body: str
    band: int = 0
    grid: int = 0
    blocks_per_sm: int = 0
    smem: int = 0

    @property
    def bands(self) -> int:
        return -(-self.H // self.band) if self.band else 0

    @property
    def units(self) -> int:
        return self.N * self.bands

    def steps(self, u: int) -> int:
        """Steps of MMA_ROWS output rows in unit ``u``."""
        rows = min(self.band, self.H - (u % self.bands) * self.band)
        return -(-rows // MMA_ROWS)

    @property
    def stem_rows(self) -> int:
        """Stem rows the body computes over the call: MMA_ROWS a step and
        two more at the start of each unit (the rows above and at its first
        output row)."""
        return sum(MMA_ROWS * self.steps(u) + 2 for u in range(self.units))

    @property
    def recompute(self) -> float:
        """Stem rows computed over the stem rows of the image (K1 + K1
        computes each once)."""
        return self.stem_rows / (self.N * self.H)

    def text(self) -> str:
        if self.body != "mma":
            return self.body
        return (f"mma band {self.band} grid {self.grid} "
                f"{self.blocks_per_sm}/SM smem {self.smem} stem x"
                f"{self.recompute:.4f}")


@functools.lru_cache(maxsize=256)
def stem_conv_plan(N: int, H: int, W: int, c1: int, cout: int,
                   aligned: bool = True, sms: int = H100_SMS) -> StemConvPlan:
    """K10's plan for an (N, H, W, 1) image, c1 stem and cout conv1
    channels. ``aligned``: the image pointer is 16-byte aligned (the
    weights and outputs are fresh tensors); ``sms``: the card's SM count.

    The mma.sync body takes c1 = cout = 32 (one K chunk of conv1, whose
    pixels the stem's products write 8 bytes a lane), W a multiple of 16
    (whole 16-pixel products, 16-byte copies of the image rows), an
    aligned image, and where one block's shared memory fits an SM: the
    served f = 32 stem. Every other call (f = 16, whose blk0_conv1 is not
    on K1's mma.sync body either, any c1 <= 32 it does not admit) stays on
    the dp4a body.

    Two blocks an SM where their shared memory fits (the kernel's
    ``__launch_bounds__`` holds a thread to 128 registers), else one. The
    band (output rows a unit, a multiple of MMA_ROWS) is the one among 4,
    8, 16, ... and the image's height that minimises the waves of units
    over the resident blocks times the stem rows a unit computes (band +
    2): long bands recompute less of the stem, short ones fill the card.
    At batch 32, 512^2 that is 64 rows, 256 units in one wave; the grid is
    the resident blocks, or the units where there are fewer."""
    smem = stem_mma_smem(W)
    per_sm = min(2, SM_SMEM // (smem + BLOCK_SMEM_RESERVED))
    if not (c1 == MMA_C and cout == MMA_C and W >= MMA_COLS
            and W % MMA_COLS == 0 and H >= 2 and H % 2 == 0 and aligned
            and per_sm >= 1):
        return StemConvPlan(N, H, W, c1, cout, "dp4a")
    slots = per_sm * sms
    tall = _round_up(H, MMA_ROWS)
    bands = [MMA_ROWS << i for i in range(tall.bit_length())
             if MMA_ROWS << i < tall] + [tall]
    band = min(bands, key=lambda b: -(-N * -(-H // b) // slots) * (b + 2))
    units = N * -(-H // band)
    return StemConvPlan(N, H, W, c1, cout, "mma", band, min(units, slots),
                        per_sm, smem)


def stem_conv_int8_reference(x: torch.Tensor, w0: torch.Tensor,
                             scale0: torch.Tensor, bias0: torch.Tensor,
                             w1: torch.Tensor, scale1: torch.Tensor,
                             bias1: torch.Tensor, w_mma=None):
    """Plain version of K10 (any device): K1's plain version twice (it
    reads ``w0`` and ``w1`` and leaves ``w_mma``, the same weights in
    another order)."""
    mid = conv3x3_int8_reference((x,), w0, scale0, bias0)
    return conv3x3_int8_reference((mid,), w1, scale1, bias1, pool=True)


def stem_conv_int8(x: torch.Tensor, w0: torch.Tensor, scale0: torch.Tensor,
                   bias0: torch.Tensor, w1: torch.Tensor,
                   scale1: torch.Tensor, bias1: torch.Tensor, w_mma=None):
    """K10: (N, H, W, 1) int8 image -> ((N, H, W, cout), (N, H/2, W/2,
    cout)) int8. w0, w1: ``pack_conv3x3_weights`` of the stem's (c1, 1, 3,
    3) and blk0_conv1's (cout, c1, 3, 3) weights; c1 <= 32; H, W even.

    The body is ``stem_conv_plan``'s. The mma.sync body reads ``w_mma =
    (w0_m, w1_m)``: ``pack_stem_mma_weights`` of the stem's weights and
    ``pack_conv3x3_mma_weights`` of blk0_conv1's, packed once at quantize
    time (the serving qparams' ``w_m``); given none (or None for one), an
    admitted call packs them from ``w0`` and ``w1``. The dp4a body reads
    ``w0`` and ``w1``."""
    _check(x.dim() == 4 and x.shape[-1] == 1 and x.shape[1] % 2 == 0
           and x.shape[2] % 2 == 0,
           f"stem_conv_int8: expected (N, H, W, 1) with even H, W, got "
           f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return stem_conv_int8_reference(x, w0, scale0, bias0, w1, scale1,
                                        bias1)
    dev = x.device
    _check(dev.type == "cuda", f"stem_conv_int8: unsupported device {dev}")
    _check_cuda_int8(x, 4, "stem_conv_int8 image", dev)
    N, H, W, _ = x.shape
    c1, cout = scale0.shape[0], scale1.shape[0]
    _check(1 <= c1 <= MAX_C1, f"stem_conv_int8: c1 {c1}, at most {MAX_C1}")
    c1p, cinp, coutp = _round_up(c1, 32), conv3x3_chunk(c1), \
        _round_up(cout, 32)
    _check_cuda_int8(w0, 4, "stem_conv_int8 stem weights", dev)
    _check(tuple(w0.shape) == (9, 1, c1p, 4),
           f"stem_conv_int8: stem weights {tuple(w0.shape)}, expected "
           f"{(9, 1, c1p, 4)}")
    _check_cuda_int8(w1, 4, "stem_conv_int8 conv1 weights", dev)
    _check(tuple(w1.shape) == (9, cinp // 4, coutp, 4),
           f"stem_conv_int8: conv1 weights {tuple(w1.shape)}, expected "
           f"{(9, cinp // 4, coutp, 4)}")
    _check_vec(scale0, c1, "stem_conv_int8 scale0", dev)
    _check_vec(bias0, c1, "stem_conv_int8 bias0", dev)
    _check_vec(scale1, cout, "stem_conv_int8 scale1", dev)
    _check_vec(bias1, cout, "stem_conv_int8 bias1", dev)
    plan = stem_conv_plan(N, H, W, c1, cout, x.data_ptr() % 16 == 0,
                          _sm_count(dev.index if dev.index is not None
                                    else torch.cuda.current_device()))
    if plan.body == "mma":
        w0_m, w1_m = w_mma if w_mma is not None else (None, None)
        if w0_m is None:
            w0_m = stem_weights_from_dp4a(w0, c1)
        if w1_m is None:
            w1_m = mma_weights_from_dp4a(w1)
        _check_cuda_int8(w0_m, 2, "stem_conv_int8 stem mma weights", dev)
        _check(tuple(w0_m.shape) == (c1, STEM_K)
               and w0_m.data_ptr() % 16 == 0,
               f"stem_conv_int8: stem mma weights {tuple(w0_m.shape)}, "
               f"expected 16-byte aligned {(c1, STEM_K)}")
        _check_cuda_int8(w1_m, 4, "stem_conv_int8 conv1 mma weights", dev)
        _check(tuple(w1_m.shape) == (1, 9, cout, KCHUNK)
               and w1_m.data_ptr() % 16 == 0,
               f"stem_conv_int8: conv1 mma weights {tuple(w1_m.shape)}, "
               f"expected 16-byte aligned {(1, 9, cout, KCHUNK)}")
    y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
    yp = torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        if plan.body == "mma":
            err = _build.lib().octseg_stem_conv_int8_mma(
                x.data_ptr(), w0_m.data_ptr(), scale0.data_ptr(),
                bias0.data_ptr(), w1_m.data_ptr(), scale1.data_ptr(),
                bias1.data_ptr(), y.data_ptr(), yp.data_ptr(), N, H, W,
                plan.band, plan.grid, plan.smem, _stream(x))
        else:
            err = _build.lib().octseg_stem_conv_int8(
                x.data_ptr(), w0.data_ptr(), scale0.data_ptr(),
                bias0.data_ptr(), w1.data_ptr(), scale1.data_ptr(),
                bias1.data_ptr(), y.data_ptr(), yp.data_ptr(), N, H, W, c1,
                c1p, cinp, cout, coutp, _stream(x))
    _build.check(err, f"stem_conv_int8 ({plan.body})")
    stem_conv_int8.launches += 1
    return y, yp


stem_conv_int8.launches = 0
