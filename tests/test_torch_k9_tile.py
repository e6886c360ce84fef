"""K9's tiled body (``csrc/dice_ce.cu:dice_ce_bwd_kernel``) on the CPU:
``bwd_plan`` (tiles a multiple of 8 pixels, 16-byte tile starts for both
logit dtypes and label widths at any C, the shared memory, the persistent
grid), the tail predicate (every pixel computed once), the byte movement
emulated in numpy (the 16-byte copies with a ragged last unit, the
output tile's 16-byte stores and element tail: every output byte written
once) with the plain version's dlogits computed from the copied tile,
and the ctypes binding of the changed entry points. K8's two kernels are
untouched. Imports no JAX.
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
    dice_ce as k89,
)

SMEM_MAX = 232448  # an H100 block's shared memory (227 KB)
DTYPES = {"bf16": (torch.bfloat16, 2), "fp32": (torch.float32, 4)}
LABELS = {"int32": (torch.int32, 4), "int64": (torch.int64, 8)}


@pytest.mark.parametrize("C", [1, 5, 10, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("labels", sorted(LABELS))
def test_bwd_plan(C, dtype, labels):
    """Tiles of a multiple of 8 pixels; every tile's logits and labels
    start on 16 bytes and hold whole 16-byte units; two slots and the
    output tile fit a block; the grid no larger than the tiles or the
    co-resident blocks."""
    xb, lb = DTYPES[dtype][1], LABELS[labels][1]
    for P in (1, 7, 256, 257, 8 * 512 * 512):
        for co_resident in (1, 528, 10 ** 6):
            plan = k89.bwd_plan(P, C, xb, lb, co_resident=co_resident)
            assert plan.tile % 8 == 0
            assert plan.tile * C * xb % 16 == 0 and plan.tile * lb % 16 == 0
            assert plan.smem == plan.tile * ((k89.BWD_STAGES + 1) * C * xb
                                             + k89.BWD_STAGES * lb)
            assert plan.smem + 4 * 3 * k89.MAX_CLASSES <= SMEM_MAX
            assert 1 <= plan.grid <= min(plan.tiles, co_resident)


@pytest.mark.parametrize("P", [1, 7, 255, 256, 300, 1025])
@pytest.mark.parametrize("grid", [1, 3, 64])
def test_tail_predicate_covers_every_pixel_once(P, grid):
    """Block g takes tiles g, g + grid, ...; thread i of a tile computes
    pixel p0 + i where i < min(tile, P - p0): every pixel once."""
    plan = k89.bwd_plan(P, 10, 2, 8, co_resident=grid)
    seen = np.zeros(P, int)
    for g in range(plan.grid):
        for tile in range(g, plan.tiles, plan.grid):
            p0 = tile * plan.tile
            np_ = min(plan.tile, P - p0)
            assert np_ > 0
            for i in range(plan.tile):
                if i < np_:
                    seen[p0 + i] += 1
    assert (seen == 1).all()


def _copy_tile(dst, src, n):
    """copy_tile: the 16-byte units of bytes [0, n) of ``src`` into ``dst``,
    the last one's bytes past n zero; -> units copied."""
    units = -(-n // 16)
    for u in range(units):
        k = min(16, n - 16 * u)
        dst[16 * u:16 * u + 16] = 0
        dst[16 * u:16 * u + k] = src[16 * u:16 * u + k]
    return units


def emulate(x, labels, coef, plan, seed=0):
    """K9's tiles in numpy: each tile's logits and labels copied into a
    slot (a ring of random bytes), the plain version's dlogits of the
    tile's valid pixels read back from the slot written into the output
    tile, then the 16-byte stores and the element tail. -> (dlogits,
    count of writes of each output byte)."""
    C, xb, lb = plan.C, plan.x_bytes, plan.lab_bytes
    xs = x.reshape(-1).view(torch.int16 if xb == 2 else torch.int32).numpy() \
        .view(np.uint8)
    ls = labels.reshape(-1).numpy().view(np.uint8)
    out = np.zeros(plan.P * C * xb, np.uint8)
    writes = np.zeros(plan.P * C * xb, int)
    rng = np.random.default_rng(seed)
    XB, LB = plan.tile * C * xb, plan.tile * lb
    S = k89.BWD_STAGES
    for g in range(plan.grid):
        smem = rng.integers(0, 256, plan.smem).astype(np.uint8)
        for i, tile in enumerate(range(g, plan.tiles, plan.grid)):
            slot = i % S
            p0 = tile * plan.tile
            np_ = min(plan.tile, plan.P - p0)
            xo, lo = p0 * C * xb, p0 * lb
            _copy_tile(smem[slot * XB:], xs[xo:], np_ * C * xb)
            _copy_tile(smem[S * XB + slot * LB:], ls[lo:], np_ * lb)
            xt = torch.from_numpy(smem[slot * XB:slot * XB + np_ * C * xb]
                                  .copy().view(np.int16 if xb == 2
                                               else np.int32)) \
                .view(x.dtype).reshape(np_, C)
            lt = torch.from_numpy(smem[S * XB + slot * LB:
                                       S * XB + slot * LB + np_ * lb].copy()
                                  .view(np.int32 if lb == 4 else np.int64))
            d = k89.dice_ce_bwd_reference(xt, lt, coef)
            os_ = smem[S * (XB + LB):]
            os_[:np_ * C * xb] = d.reshape(-1).view(
                torch.int16 if xb == 2 else torch.int32).numpy().view(np.uint8)
            n = np_ * C * xb
            units = n // 16
            out[xo:xo + 16 * units] = os_[:16 * units]
            writes[xo:xo + 16 * units] += 1
            out[xo + 16 * units:xo + n] = os_[16 * units:n]  # element tail
            writes[xo + 16 * units:xo + n] += 1
    dx = torch.from_numpy(out.view(np.int16 if xb == 2 else np.int32)) \
        .view(x.dtype).reshape(x.shape)
    return dx, writes


@pytest.mark.parametrize("shape,C,dtype,labels", [
    ((1, 7, 9), 5, "bf16", "int64"),     # one ragged tile, 10-byte pixels
    ((2, 17, 15), 10, "bf16", "int32"),  # three tiles, the last ragged
    ((1, 16, 32), 32, "fp32", "int64"),  # two whole tiles
    ((1, 33, 9), 1, "fp32", "int32"),    # C = 1
])
def test_bwd_tile_emulation_matches_plain(shape, C, dtype, labels):
    """The bytes reach the right pixels: the emulated kernel's dlogits
    equal the plain version's over the whole tensor, every output byte
    written exactly once, on two blocks (a ring slot reused)."""
    rng = np.random.default_rng(C)
    x = torch.tensor(rng.standard_normal(shape + (C,)) * 3,
                     dtype=DTYPES[dtype][0])
    lab = rng.integers(0, C + 1, shape)  # C: outside the classes
    labels_t = torch.tensor(lab, dtype=LABELS[labels][0])
    coef = torch.tensor(rng.normal(0, 1e-3, 3 * C), dtype=torch.float32)
    P = int(np.prod(shape))
    plan = k89.bwd_plan(P, C, DTYPES[dtype][1], LABELS[labels][1],
                        co_resident=2)
    dx, writes = emulate(x, labels_t, coef, plan)
    assert (writes == 1).all()
    assert torch.equal(dx, k89.dice_ce_bwd_reference(x, labels_t, coef))


def test_k9_binding_matches_the_c_entry_points():
    """The ctypes argument lists of K9's two entry points (and K8's,
    unchanged) have one entry per parameter of the C functions: pointers
    where they take pointers, 64-bit integers where they take ``long
    long``."""
    src = (_build.CSRC / "dice_ce.cu").read_text()
    for name in ("octseg_dice_ce_bwd", "octseg_dice_ce_bwd_resident",
                 "octseg_dice_ce_stats"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           src).group(1).split(",")
        argtypes = _build.SIGNATURES[name]
        assert len(params) == len(argtypes)
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
            assert ("long long" in p) == (t is ctypes.c_longlong), (p, t)
    assert re.search(r"constexpr int BWD_TP = THREADS;", src)
    assert re.search(rf"constexpr int BWD_STAGES = {k89.BWD_STAGES};", src)
    assert re.search(rf"constexpr int THREADS = {k89.BWD_TILE};", src)
