"""K3: the 1x1 int8 classifier head fused with the per-pixel argmax.

Replaces the TPU kernel ``ops/pallas_conv_psrp.py:head_argmax_psrp``. Per
pixel: the int8 dot of the cin channels with each class's weights, the
float32 logit ``fmaf(float(acc), scale[k], bias[k])`` (no round, no clip,
``scale = s_head_in*s_w``, ``bias = b``), and the argmax with ties going to
the lowest class. Output: (N, H, W) int8 labels; the logits never reach
device memory.

The wrapper runs the CUDA kernel (``csrc/head_argmax.cu``) for a CUDA
tensor and the plain version only for a CPU tensor.
"""

from __future__ import annotations

import torch

from . import _build
from .conv_int8 import _check, _check_cuda_int8, _check_vec, _stream

MAX_CIN = 64
MAX_CLASSES = 32


def pack_head_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(nc, cin, 1, 1) int8 -> (nc, cin) int8, read as int32 words of 4
    channels; cin must be a multiple of 4."""
    nc, cin = w_q.shape[:2]
    assert cin % 4 == 0 and w_q.dtype == torch.int8, w_q.shape
    return w_q.reshape(nc, cin).contiguous()


def head_argmax_reference(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 (any device)."""
    acc = x.double() @ w.double().T  # exact: |acc| << 2^53
    z = (acc.float().double() * scale.double() + bias.double()).float()
    return z.argmax(dim=-1).to(torch.int8)  # first maximum on ties


def head_argmax(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """(N, H, W, cin) int8 -> (N, H, W) int8 labels. w: ``pack_head_weights``."""
    if x.device.type == "cpu":
        return head_argmax_reference(x, w, scale, bias)
    dev = x.device
    _check(dev.type == "cuda", f"head_argmax: unsupported device {dev}")
    _check_cuda_int8(x, 4, "head_argmax input", dev)
    cin = x.shape[-1]
    nc = scale.shape[0]
    _check(cin % 4 == 0 and cin <= MAX_CIN,
           f"head_argmax: cin {cin} must be a multiple of 4, <= {MAX_CIN}")
    _check(1 <= nc <= MAX_CLASSES,
           f"head_argmax: {nc} classes, at most {MAX_CLASSES}")
    _check_cuda_int8(w, 2, "head_argmax weights", dev)
    _check(tuple(w.shape) == (nc, cin),
           f"head_argmax: weights {tuple(w.shape)}, expected {(nc, cin)}")
    _check_vec(scale, nc, "head_argmax scale", dev)
    _check_vec(bias, nc, "head_argmax bias", dev)
    y = torch.empty(x.shape[:3], dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_head_argmax(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), y.numel(), cin // 4, nc, _stream(x))
    _build.check(err, "head_argmax")
    head_argmax.launches += 1
    return y


head_argmax.launches = 0
