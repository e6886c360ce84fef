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
tensor. The plain versions compute in float64 and round as the kernels do:
to float32 (the accumulator), then, for K4, to bf16. Where every fp32
partial sum is exact (small integer inputs) kernel and plain version are
bit-equal; on random data K4 may differ by one bf16 ulp on a few elements.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build
from .conv_int8 import _check, _round_up, _stream

_KC, _CO_T = 16, 32  # K5's channel tiles (csrc/conv3x3_bf16.cu)


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


def conv3x3_bf16_fwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4: (N, H, W, cin) bf16 * (3, 3, cin, cout) bf16 -> (N, H, W, cout)
    bf16. Forward, and the dgrad on ``flip_w`` weights."""
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
    y = torch.empty((N, H, W, cout), dtype=torch.bfloat16, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_conv3x3_bf16(
            x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, cin, cout,
            _stream(x))
    _build.check(err, "conv3x3_bf16")
    conv3x3_bf16_fwd.launches += 1
    return y


conv3x3_bf16_fwd.launches = 0


def wgrad_groups(N: int, H: int, W: int, cin: int, cout: int) -> int:
    """K5's number of pixel groups G (one fp32 partial each): about 2048
    blocks in all, and no more groups than 8x16 output tiles."""
    tiles = N * -(-H // 8) * -(-W // 16)
    channel_tiles = -(-cin // _KC) * -(-cout // _CO_T)
    return max(1, min(tiles, 2048 // channel_tiles))


def conv3x3_bf16_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K5: dW[ky, kx, ci, co] = sum over n, h, w of x[n, h+ky-1, w+kx-1, ci]
    * dy[n, h, w, co]; (3, 3, cin, cout) float32."""
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
    cinp, coutp = _round_up(cin, _KC), _round_up(cout, _CO_T)
    G = wgrad_groups(N, H, W, cin, cout)
    partial = torch.empty((G, 9, cinp, coutp), dtype=torch.float32,
                          device=dev)
    dw = torch.empty((3, 3, cin, cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_conv3x3_bf16_wgrad(
            x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr(),
            N, H, W, cin, cout, cinp, coutp, G, _stream(x))
    _build.check(err, "conv3x3_bf16_wgrad")
    conv3x3_bf16_wgrad.launches += 1
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
