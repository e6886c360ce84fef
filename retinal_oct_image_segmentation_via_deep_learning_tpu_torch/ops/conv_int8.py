"""Int8 convolutions of the serving path: K1 (3x3) and K2 (2x2/2 transposed).

Both take NHWC int8 activations, contiguous, and end in the same fused
requant: ``v = fmaf(float(acc), scale[co], bias[co])``, then (K1 only) relu,
then round-half-even, clip to [-127, 127], int8. ``scale = (s_in*s_w)/s_out``
and ``bias = b/s_out`` are per output channel, float32.

Each wrapper runs its CUDA kernel (``csrc/``) for a CUDA tensor, and its
plain PyTorch version (``*_reference``) only for a CPU tensor. The plain
versions do the products in float64, which is exact here (|acc| reaches
9*512*127^2 ~ 7.4e7 > 2^24, beyond float32), and emulate the FMA as
``(float(acc) as double * scale + bias)`` rounded once to float32 (the
product of two float32 values is exact in float64).

Weights are packed once, at quantize time, into the order the kernels read
(``pack_conv3x3_weights``, ``pack_ct2x2_weights``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from . import _build


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def requant_reference(acc: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, *, relu: bool) -> torch.Tensor:
    """float64 integer accumulators (channels last) -> int8, the kernels'
    epilogue: FMA, relu, round-half-even, clip +-127."""
    v = (acc.float().double() * scale.double() + bias.double()).float()
    if relu:
        v = v.clamp_min(0.0)
    return torch.round(v).clamp(-127, 127).to(torch.int8)


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


def conv3x3_int8_reference(inputs: Sequence[torch.Tensor], w: torch.Tensor,
                           scale: torch.Tensor, bias: torch.Tensor, *,
                           relu: bool = True, pool: bool = False):
    """Plain version of K1 (any device)."""
    x = torch.cat(tuple(inputs), dim=-1) if len(inputs) > 1 else inputs[0]
    cout = scale.shape[0]
    wd = unpack_conv3x3_weights(w, x.shape[-1], cout).double()
    acc = F.conv2d(x.permute(0, 3, 1, 2).double(), wd, padding=1)
    y = requant_reference(acc.permute(0, 2, 3, 1), scale, bias, relu=relu)
    y = y.contiguous()
    if not pool:
        return y
    n, h, wd_, c = y.shape
    p = y.reshape(n, h // 2, 2, wd_ // 2, 2, c).amax(dim=(2, 4))
    return y, p.contiguous()


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


def conv3x3_int8(inputs, w: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, *, relu: bool = True,
                 pool: bool = False):
    """K1: int8 3x3 'same' conv over the channel concat of 1-2 NHWC inputs.

    inputs: one (N, H, W, C) int8 tensor or a tuple of two (the concat is
    folded into the kernel: no ``torch.cat`` is made). w:
    ``pack_conv3x3_weights`` of the (cout, sum C, 3, 3) weights. Returns
    (N, H, W, cout) int8; with ``pool=True`` also its 2x2/2 max-pool.
    """
    inputs = tuple(inputs) if isinstance(inputs, (tuple, list)) else (inputs,)
    x0 = inputs[0]
    if x0.device.type == "cpu":
        return conv3x3_int8_reference(inputs, w, scale, bias, relu=relu,
                                      pool=pool)
    dev = x0.device
    _check(dev.type == "cuda", f"conv3x3_int8: unsupported device {dev}")
    _check(1 <= len(inputs) <= 2, "conv3x3_int8: one or two inputs")
    for k, t in enumerate(inputs):
        _check_cuda_int8(t, 4, f"conv3x3_int8 input {k}", dev)
        _check(t.shape[:3] == x0.shape[:3],
               f"conv3x3_int8: input shapes {[tuple(t.shape) for t in inputs]}")
    N, H, W, cin0 = x0.shape
    cin1 = inputs[1].shape[-1] if len(inputs) > 1 else 0
    cout = scale.shape[0]
    _check_cuda_int8(w, 4, "conv3x3_int8 weights", dev)
    cinp, coutp = conv3x3_chunk(cin0 + cin1), _round_up(cout, 32)
    _check(tuple(w.shape) == (9, cinp // 4, coutp, 4),
           f"conv3x3_int8: weights {tuple(w.shape)}, expected "
           f"{(9, cinp // 4, coutp, 4)}")
    _check_vec(scale, cout, "conv3x3_int8 scale", dev)
    _check_vec(bias, cout, "conv3x3_int8 bias", dev)
    _check(not pool or (H % 2 == 0 and W % 2 == 0),
           f"conv3x3_int8: pool needs even H, W, got {(H, W)}")
    y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
    yp = (torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8,
                      device=dev) if pool else None)
    x1 = inputs[1] if len(inputs) > 1 else None
    with torch.cuda.device(dev):
        err = _build.lib().octseg_conv3x3_int8(
            x0.data_ptr(), cin0, x1.data_ptr() if x1 is not None else None,
            cin1, w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), yp.data_ptr() if pool else None, N, H, W, cinp,
            cout, coutp, int(relu), _stream(x0))
    _build.check(err, "conv3x3_int8")
    conv3x3_int8.launches += 1
    return (y, yp) if pool else y


conv3x3_int8.launches = 0


# ---------------------------------------------------------------------------
# K2: 2x2/2 transposed conv (replaces ct2x2_int8, ct_up_psrp and ct_psrp)
# ---------------------------------------------------------------------------


def pack_ct2x2_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(cin, cout, 2, 2) int8 (ConvTranspose2d layout) -> (cinp/4, colp, 4)
    int8: int32 word [j, col] holds w[4j..4j+3, co, dy, dx] for column
    col = (2*dy + dx)*cout + co; cinp = cin padded to 32, colp = 4*cout
    padded to 64, zero padding."""
    cin, cout, kh, kw = w_q.shape
    assert (kh, kw) == (2, 2) and w_q.dtype == torch.int8, w_q.shape
    cinp, colp = _round_up(cin, 32), _round_up(4 * cout, 64)
    dense = torch.zeros(cinp, colp, dtype=torch.int8, device=w_q.device)
    dense[:cin, :4 * cout] = w_q.permute(0, 2, 3, 1).reshape(cin, 4 * cout)
    return dense.reshape(cinp // 4, 4, colp).permute(0, 2, 1).contiguous()


def ct2x2_int8_reference(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K2 (any device)."""
    N, H, W, cin = x.shape
    cout = scale.shape[0]
    dense = w.permute(0, 2, 1).reshape(-1, w.shape[1])[:cin, :4 * cout]
    acc = x.reshape(-1, cin).double() @ dense.double()
    acc = acc.reshape(N, H, W, 2, 2, cout)
    y = requant_reference(acc, scale, bias, relu=False)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(N, 2 * H, 2 * W, cout)


def ct2x2_int8(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    """K2: (N, H, W, cin) int8 -> (N, 2H, 2W, cout) int8 with
    out[n, 2i+dy, 2j+dx, co] = requant(x[n, i, j, :] . w[:, co, dy, dx]),
    no relu. w: ``pack_ct2x2_weights``; cin must be a multiple of 4."""
    if x.device.type == "cpu":
        return ct2x2_int8_reference(x, w, scale, bias)
    dev = x.device
    _check(dev.type == "cuda", f"ct2x2_int8: unsupported device {dev}")
    _check_cuda_int8(x, 4, "ct2x2_int8 input", dev)
    N, H, W, cin = x.shape
    cout = scale.shape[0]
    _check(cin % 4 == 0, f"ct2x2_int8: cin {cin} not a multiple of 4")
    _check_cuda_int8(w, 3, "ct2x2_int8 weights", dev)
    cinp, colp = _round_up(cin, 32), _round_up(4 * cout, 64)
    _check(tuple(w.shape) == (cinp // 4, colp, 4),
           f"ct2x2_int8: weights {tuple(w.shape)}, expected "
           f"{(cinp // 4, colp, 4)}")
    _check_vec(scale, cout, "ct2x2_int8 scale", dev)
    _check_vec(bias, cout, "ct2x2_int8 bias", dev)
    y = torch.empty((N, 2 * H, 2 * W, cout), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_ct2x2_int8(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), N, H, W, cin, cinp, cout, colp, _stream(x))
    _build.check(err, "ct2x2_int8")
    ct2x2_int8.launches += 1
    return y


ct2x2_int8.launches = 0
