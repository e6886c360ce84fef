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
packed once, at quantize time (``pack_conv7x3_weights``).
"""

from __future__ import annotations

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


def pack_conv7x3_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(cout, cin, kh, 3) int8 -> (kh*3, cinp/4, coutp, 4) int8: int32 word
    [t, j, co] holds w[co, 4j..4j+3, t//3, t%3]; zero padding to cinp
    (``conv3x3_chunk``: 4 for cin <= 4, else a multiple of 32) and coutp
    (a multiple of 32)."""
    cout, cin, kh, kw = w_q.shape
    assert kh in KERNEL_HEIGHTS and kw == 3 and w_q.dtype == torch.int8, \
        w_q.shape
    cinp, coutp = conv3x3_chunk(cin), _round_up(cout, 32)
    dense = torch.zeros(kh * 3, cinp, coutp, dtype=torch.int8,
                        device=w_q.device)
    dense[:, :cin, :cout] = w_q.permute(2, 3, 1, 0).reshape(kh * 3, cin, cout)
    return (dense.reshape(kh * 3, cinp // 4, 4, coutp).permute(0, 1, 3, 2)
            .contiguous())


def unpack_conv7x3_weights(w: torch.Tensor, cin: int,
                           cout: int) -> torch.Tensor:
    """Inverse of ``pack_conv7x3_weights``: (cout, cin, kh, 3) int8."""
    taps, cw, coutp, four = w.shape
    dense = w.permute(0, 1, 3, 2).reshape(taps, cw * 4, coutp)[:, :cin, :cout]
    return dense.reshape(taps // 3, 3, cin, cout).permute(3, 2, 0, 1)


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
    kh = w.shape[0] // 3
    cinp, coutp = conv3x3_chunk(cin0 + cin1), _round_up(cout, 32)
    _check(kh in KERNEL_HEIGHTS
           and tuple(w.shape) == (3 * kh, cinp // 4, coutp, 4),
           f"conv7x3_int8: weights {tuple(w.shape)}, expected "
           f"(3*kh, {cinp // 4}, {coutp}, 4) with kh in {KERNEL_HEIGHTS}")
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
    with torch.cuda.device(dev):
        err = _build.lib().octseg_conv7x3_int8(
            x0.data_ptr(), cin0, x1.data_ptr() if x1 is not None else None,
            cin1, w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            _alpha32(alpha), y.data_ptr(), yp.data_ptr() if pool else None,
            yi.data_ptr() if pool else None, N, H, W, cinp, cout, coutp, kh,
            _stream(x0))
    _build.check(err, "conv7x3_int8")
    conv7x3_int8.launches += 1
    return (y, yp, yi) if pool else y


conv7x3_int8.launches = 0
