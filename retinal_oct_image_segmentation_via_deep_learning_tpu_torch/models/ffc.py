"""The Fast Fourier Convolution stack (the JAX package's ``models/ffc.py``),
NCHW, shared by Y-Net's spectral encoder and EdgeAL.

- ``FourierUnit``: rfft2 (norm 'ortho') in float32 -> per-channel [real,
  imag] interleave into 2C channels (c0_re, c0_im, c1_re, ...) -> 1x1 conv
  (no bias) -> BN -> ReLU -> back to complex -> irfft2 to the input's
  size, cast back to the input's dtype. The FFTs run in float32 under any
  autocast, as JAX runs them.
- ``SpectralTransform``: a stride-2 average pool first where asked, 1x1
  conv-BN-ReLU to C/2, the global ``FourierUnit``, and the local one (LFU)
  over the first C/4 channels of the 2x2 spatial quarters stacked on the
  channels (rows split, then columns, both at H // 2), tiled 2x2 back;
  a final 1x1 conv of their sum.
- ``FFC``: local and global streams through four paths, registered (and
  so listed in ``utils/convert``'s layer maps) in the order l2l, l2g, g2l,
  g2g (the spectral transform); reflect padding before each conv.
- ``FFC_BN_ACT``: an ``FFC``, then BatchNorm and an activation per stream.
- ``FFCResnetBlock``: two ``FFC_BN_ACT`` with a residual add per stream.
- ``FFCSEBlock``: squeeze-excitation over a stream; ``concat_stream``.
- ``LearnableSpatialTransformWrapper``: reflect pad, rotate by a learnable
  angle (``ops/sampling.reference_rotate``), the wrapped module, rotate
  back, crop.

A stream is a ``(local, global)`` tuple in which either entry may be None.
JAX infers input channels; here each layer takes its input split
``cin = (local, global)``, and a layer's output split is
``split_channels(features, ratio_gout)``: the global share
``int(features * ratio_gout)`` truncates, as JAX's does.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import avg_pool
from ..ops.sampling import reference_rotate
from .blocks import activation, batch_norm, conv

Stream = tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def split_channels(channels: int, ratio: float) -> tuple[int, int]:
    """-> (local, global) channel counts of a stream of ``channels``."""
    cg = int(channels * ratio)
    return channels - cg, cg


class FourierUnit(nn.Module):
    def __init__(self, cin: int, features: int, groups: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = conv(2 * cin, 2 * features, 1, groups=groups,
                         bias=False, generator=generator)
        self.bn = batch_norm(2 * features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        H, W = x.shape[-2:]
        ff = torch.fft.rfft2(x.float(), dim=(-2, -1), norm="ortho")
        ff = torch.stack([ff.real, ff.imag], dim=2).flatten(1, 2)
        ff = F.relu(self.bn(self.conv(ff)))
        ff = ff.float().unflatten(1, (-1, 2))
        out = torch.fft.irfft2(torch.complex(ff[:, :, 0], ff[:, :, 1]),
                               s=(H, W), dim=(-2, -1), norm="ortho")
        return out.to(x.dtype)


class SpectralTransform(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 groups: int = 1, enable_lfu: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        g, half = generator, features // 2
        self.stride = stride
        self.conv1 = conv(cin, half, 1, groups=groups, bias=False,
                          generator=g)
        self.bn = batch_norm(half)
        self.fu = FourierUnit(half, half, groups, generator=g)
        self.lfu = (FourierUnit(4 * (half // 4), half, groups, generator=g)
                    if enable_lfu else None)
        self.conv2 = conv(half, features, 1, groups=groups, bias=False,
                          generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 2:
            x = avg_pool(x, 2)
        x = F.relu(self.bn(self.conv1(x)))
        out = self.fu(x)
        xs = 0
        if self.lfu is not None:
            C, s = x.shape[1], x.shape[2] // 2
            xs = x[:, : C // 4]
            xs = torch.cat([xs[:, :, :s], xs[:, :, s:2 * s]], dim=1)
            xs = torch.cat([xs[..., :s], xs[..., s:2 * s]], dim=1)
            xs = self.lfu(xs).repeat(1, 1, 2, 2)
        return self.conv2(x + out + xs)


def _add(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


class FFC(nn.Module):
    """Four-path local/global convolution of a stream split ``cin``."""

    def __init__(self, cin: tuple[int, int], features: int,
                 kernel_size: int = 3, ratio_gout: float = 0.5,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 bias: bool = False, enable_lfu: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        in_cl, in_cg = cin
        out_cl, out_cg = split_channels(features, ratio_gout)
        self.padding = padding

        def path(ci, co):
            if ci == 0 or co == 0:
                return None
            return conv(ci, co, kernel_size, stride, 0, dilation, bias=bias,
                        generator=generator)

        self.l2l = path(in_cl, out_cl)
        self.l2g = path(in_cl, out_cg)
        self.g2l = path(in_cg, out_cl)
        self.g2g = (SpectralTransform(in_cg, out_cg, stride, 1, enable_lfu,
                                      generator=generator)
                    if in_cg and out_cg else None)
        has_l = self.l2l is not None or self.g2l is not None
        has_g = self.l2g is not None or self.g2g is not None
        self.out_channels = (out_cl if has_l else 0, out_cg if has_g else 0)

    def forward(self, x) -> Stream:
        x_l, x_g = x if isinstance(x, tuple) else (x, None)
        p = self.padding

        def run(layer, t, pad=True):
            if layer is None or t is None:
                return None
            if pad and p:
                t = F.pad(t, (p, p, p, p), mode="reflect")
            return layer(t)

        return (_add(run(self.l2l, x_l), run(self.g2l, x_g)),
                _add(run(self.l2g, x_l), run(self.g2g, x_g, pad=False)))


class FFC_BN_ACT(nn.Module):
    """``FFC`` -> BatchNorm and ``act`` on each stream that exists."""

    def __init__(self, cin: tuple[int, int], features: int,
                 kernel_size: int = 1, ratio_gout: float = 0.5,
                 stride: int = 1, padding: int = 0, dilation: int = 1,
                 act: str = "none", enable_lfu: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.ffc = FFC(cin, features, kernel_size, ratio_gout, stride,
                       padding, dilation, enable_lfu=enable_lfu,
                       generator=generator)
        out_cl, out_cg = self.out_channels = self.ffc.out_channels
        self.bn_l = batch_norm(out_cl) if out_cl else None
        self.bn_g = batch_norm(out_cg) if out_cg else None
        self.act = activation(act)

    def forward(self, x) -> Stream:
        x_l, x_g = self.ffc(x)
        if x_l is not None:
            x_l = self.act(self.bn_l(x_l))
        if x_g is not None:
            x_g = self.act(self.bn_g(x_g))
        return x_l, x_g


class FFCResnetBlock(nn.Module):
    """Two 3x3 ``FFC_BN_ACT`` (padding = dilation) and a residual add per
    stream, on a stream of ``features`` split by ``ratio_gin``."""

    def __init__(self, features: int, ratio_gin: float = 0.5,
                 ratio_gout: float = 0.5, dilation: int = 1,
                 act: str = "relu", enable_lfu: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        kw = dict(kernel_size=3, ratio_gout=ratio_gout, padding=dilation,
                  dilation=dilation, act=act, enable_lfu=enable_lfu,
                  generator=generator)
        self.conv1 = FFC_BN_ACT(split_channels(features, ratio_gin),
                                features, **kw)
        self.conv2 = FFC_BN_ACT(self.conv1.out_channels, features, **kw)
        self.out_channels = self.conv2.out_channels

    def forward(self, x: Stream) -> Stream:
        id_l, id_g = x
        x_l, x_g = self.conv2(self.conv1(x))
        if id_l is not None:
            x_l = x_l + id_l
        if id_g is not None:
            x_g = x_g + id_g
        return x_l, x_g


def concat_stream(x: Stream) -> torch.Tensor:
    """The stream as one tensor, local channels first."""
    x_l, x_g = x
    if x_g is None:
        return x_l
    if x_l is None:
        return x_g
    return torch.cat([x_l, x_g], dim=1)


class FFCSEBlock(nn.Module):
    """Squeeze-excitation of a stream of ``channels`` split by ``ratio_g``:
    global average -> 1x1 conv to channels // 16 -> ReLU -> a 1x1 gate per
    stream -> sigmoid -> scale."""

    def __init__(self, channels: int, ratio_g: float, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        in_cl, in_cg = split_channels(channels, ratio_g)
        r = channels // 16
        self.conv1 = conv(channels, r, 1, generator=g)
        self.conv_a2l = conv(r, in_cl, 1, generator=g) if in_cl else None
        self.conv_a2g = conv(r, in_cg, 1, generator=g) if in_cg else None

    def forward(self, x) -> Stream:
        x_l, x_g = x if isinstance(x, tuple) else (x, None)
        full = x_l if x_g is None else torch.cat([x_l, x_g], dim=1)
        s = F.relu(self.conv1(full.mean(dim=(2, 3), keepdim=True)))
        out_l = (x_l * torch.sigmoid(self.conv_a2l(s))
                 if self.conv_a2l is not None else None)
        out_g = (x_g * torch.sigmoid(self.conv_a2g(s))
                 if self.conv_a2g is not None else None)
        return out_l, out_g


class LearnableSpatialTransformWrapper(nn.Module):
    """Reflect-pad by ``pad_coef`` of each side -> rotate by the learnable
    ``angle`` (degrees, drawn U(0, angle_init_range)) -> ``impl`` ->
    rotate back -> crop; each entry of a tuple on its own."""

    def __init__(self, impl: nn.Module, pad_coef: float = 0.5,
                 angle_init_range: float = 80.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.angle = nn.Parameter(
            torch.rand(1, generator=generator) * angle_init_range)
        self.impl = impl
        self.pad_coef = pad_coef

    def _transform(self, t):
        ph = int(t.shape[2] * self.pad_coef)
        pw = int(t.shape[3] * self.pad_coef)
        t = F.pad(t, (pw, pw, ph, ph), mode="reflect")
        return reference_rotate(t, self.angle[0]), (ph, pw)

    def _inverse(self, t, pads):
        ph, pw = pads
        t = reference_rotate(t, -self.angle[0])
        return t[:, :, ph:t.shape[2] - ph, pw:t.shape[3] - pw]

    def forward(self, x, *args, **kwargs):
        if isinstance(x, tuple):
            trans = [self._transform(e) for e in x]
            ys = self.impl(tuple(t for t, _ in trans), *args, **kwargs)
            return tuple(self._inverse(y, pads)
                         for y, (_, pads) in zip(ys, trans))
        t, pads = self._transform(x)
        return self._inverse(self.impl(t, *args, **kwargs), pads)
