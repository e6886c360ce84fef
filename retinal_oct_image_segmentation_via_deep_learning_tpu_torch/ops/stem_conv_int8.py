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
tensor and the plain version (two calls of K1's plain version) only for a
CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from .conv_int8 import (
    _check,
    _check_cuda_int8,
    _check_vec,
    _round_up,
    _stream,
    conv3x3_chunk,
    conv3x3_int8_reference,
)

MAX_C1 = 32


def stem_conv_int8_reference(x: torch.Tensor, w0: torch.Tensor,
                             scale0: torch.Tensor, bias0: torch.Tensor,
                             w1: torch.Tensor, scale1: torch.Tensor,
                             bias1: torch.Tensor):
    """Plain version of K10 (any device): K1's plain version twice."""
    mid = conv3x3_int8_reference((x,), w0, scale0, bias0)
    return conv3x3_int8_reference((mid,), w1, scale1, bias1, pool=True)


def stem_conv_int8(x: torch.Tensor, w0: torch.Tensor, scale0: torch.Tensor,
                   bias0: torch.Tensor, w1: torch.Tensor,
                   scale1: torch.Tensor, bias1: torch.Tensor):
    """K10: (N, H, W, 1) int8 image -> ((N, H, W, cout), (N, H/2, W/2,
    cout)) int8. w0, w1: ``pack_conv3x3_weights`` of the stem's (c1, 1, 3,
    3) and blk0_conv1's (cout, c1, 3, 3) weights; c1 <= 32; H, W even."""
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
    y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
    yp = torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_stem_conv_int8(
            x.data_ptr(), w0.data_ptr(), scale0.data_ptr(), bias0.data_ptr(),
            w1.data_ptr(), scale1.data_ptr(), bias1.data_ptr(), y.data_ptr(),
            yp.data_ptr(), N, H, W, c1, c1p, cinp, cout, coutp, _stream(x))
    _build.check(err, "stem_conv_int8")
    stem_conv_int8.launches += 1
    return y, yp


stem_conv_int8.launches = 0
