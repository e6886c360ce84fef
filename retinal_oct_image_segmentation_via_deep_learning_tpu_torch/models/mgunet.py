"""MGU-Net, the multi-scale graph-reasoning U-Net (the JAX package's
``models/mgunet.py``; reference ``SOTAS/Layers_Segment/MGUNet_2021.py``),
NCHW.

- ``Basconv``: conv-BN-ReLU; ``UnetConv``: (3x3 conv-BN-ReLU) x 2.
- ``GloReUnit``: 1x1 state and projection convs C -> M, the soft adjacency
  ``softmax(s^T p / sqrt(HW))`` (M x M) and the aggregation ``adj . p`` in
  float32 under any autocast (as JAX computes them), a 1x1 extension conv
  M -> C and the residual.
- ``MGRModule``: four branches at pool scales 1, 2, 3, 5 (Basconv, then
  pool and Basconv, then a GloReUnit with M = C, C, C/2, C/2), each
  resized back bilinearly (align_corners) to the input's size,
  concatenated and fused by a 1x1 Basconv. The pools floor where the size
  is not a multiple of the scale (``ops/pooling.max_pool``).
- ``MGUNet``: widths [64, 128, 256, 512] / feature_scale, pools (2, 4, 4)
  or (2, 2, 2) (``uniform_pool``, MGU-Net-2), the MGR module and a centre
  UnetConv at the bottom, and a decoder of transposed convs k = s = pool
  (``is_deconv``) or bilinear (align_corners) + 1x1, each concatenated
  ``[skip, up]`` into a UnetConv; a 1x1 head.

Convs are He-normal (fan in) with zero biases and the BatchNorms' scale is
1 + N(0, 0.02), as in JAX. Every BatchNorm is ``blocks.BatchNorm``: the JAX
model's bare flax ``BatchNorm`` computes the same statistics (the mean and
max(E[x^2] - mean^2, 0)) and the same 0.9 / 0.1 running update, so train
mode runs K6.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.pooling import max_pool
from ..ops.resize import resize_bilinear_nchw
from .blocks import BatchNorm, Conv2d, conv_transpose, redraw


def _he_conv(cin: int, cout: int, k: int, padding: int = 0, *,
             generator: torch.Generator) -> nn.Conv2d:
    """A conv with weights N(0, 2 / fan_in) and zero biases."""
    return redraw(skip_init(Conv2d, cin, cout, k, padding=padding),
                  math.sqrt(2.0 / (cin * k * k)), generator)


def _bn(c: int, generator: torch.Generator) -> BatchNorm:
    bn = BatchNorm(c)
    with torch.no_grad():
        bn.weight.normal_(1.0, 0.02, generator=generator)
    return bn


class Basconv(nn.Module):
    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 padding: int = 1, *, generator: torch.Generator):
        super().__init__()
        self.conv = _he_conv(cin, features, kernel_size, padding,
                             generator=generator)
        self.bn = _bn(features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class UnetConv(nn.Module):
    def __init__(self, cin: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv1 = Basconv(cin, features, generator=generator)
        self.conv2 = Basconv(features, features, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class GloReUnit(nn.Module):
    def __init__(self, c: int, m: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.state = _he_conv(c, m, 1, generator=g)
        self.proj = _he_conv(c, m, 1, generator=g)
        self.extend = _he_conv(m, c, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, _, H, W = x.shape
        hw = H * W
        s = self.state(x).reshape(N, -1, hw).float()  # (n, M, hw)
        p = self.proj(x).reshape(N, -1, hw).float()
        with torch.autocast(x.device.type, enabled=False):
            adj = torch.softmax(s @ p.transpose(1, 2) / hw ** 0.5, dim=-1)
            agg = adj @ p  # (n, M, hw)
        return x + self.extend(agg.reshape(N, -1, H, W).to(x.dtype))


class MGRModule(nn.Module):
    def __init__(self, cin: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        g, f = generator, features
        self.branch0 = Basconv(cin, f, generator=g)
        self.glore0 = GloReUnit(f, f, generator=g)
        self.pools = (2, 3, 5)
        self.pre = nn.ModuleList()
        self.post = nn.ModuleList()
        self.glore = nn.ModuleList()
        for m in (f, f // 2, f // 2):
            self.pre.append(Basconv(cin, f, generator=g))
            self.post.append(Basconv(f, f, generator=g))
            self.glore.append(GloReUnit(f, m, generator=g))
        self.fuse = Basconv(4 * f, cin, 1, 0, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[-2:]
        outs = [self.glore0(self.branch0(x))]
        for pool, pre, post, glore in zip(self.pools, self.pre, self.post,
                                          self.glore):
            b = post(max_pool(pre(x), pool))
            outs.append(resize_bilinear_nchw(glore(b), hw, True))
        return self.fuse(torch.cat(outs, dim=1))


class MGUNet(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 11,
                 feature_scale: int = 4, uniform_pool: bool = False,
                 is_deconv: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        filters = [int(c / feature_scale) for c in (64, 128, 256, 512)]
        self.pools = (2, 2, 2) if uniform_pool else (2, 4, 4)
        self.is_deconv = is_deconv
        cin = in_channels
        self.encoders = nn.ModuleList()
        for f in filters[:3]:
            self.encoders.append(UnetConv(cin, f, generator=g))
            cin = f
        self.mgr = MGRModule(cin, filters[3], generator=g)
        self.center = UnetConv(cin, filters[3], generator=g)
        self.ups = nn.ModuleList()
        self.decoders = nn.ModuleList()
        cin = filters[3]
        for lvl, p in zip((2, 1, 0), reversed(self.pools)):
            f = filters[lvl]
            self.ups.append(conv_transpose(cin, f, p, p, generator=g)
                            if is_deconv else _he_conv(cin, f, 1, generator=g))
            self.decoders.append(UnetConv(2 * f, f, generator=g))
            cin = f
        self.head = _he_conv(cin, num_classes, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, h = [], x
        for enc, p in zip(self.encoders, self.pools):
            h = enc(h)
            skips.append(h)
            h = max_pool(h, p)
        h = self.center(self.mgr(h))
        for lvl, p, up, dec in zip((2, 1, 0), reversed(self.pools), self.ups,
                                   self.decoders):
            if not self.is_deconv:
                hw = (h.shape[-2] * p, h.shape[-1] * p)
                h = resize_bilinear_nchw(h, hw, True)
            h = dec(torch.cat([skips[lvl], up(h)], dim=1))
        return self.head(h)


def build_mgunet(in_channels: int = 1, num_classes: int = 11, *,
                 seed: int = 0, device: torch.device | str = "cpu",
                 **kw) -> MGUNet:
    """MGU-Net (pools 2, 4, 4) initialised on the CPU from ``seed``, then
    moved to ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = MGUNet(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()


def build_mgunet_2(in_channels: int = 1, num_classes: int = 11, *,
                   seed: int = 0, device: torch.device | str = "cpu",
                   **kw) -> MGUNet:
    """MGU-Net-2 (pools 2, 2, 2); as ``build_mgunet``."""
    return build_mgunet(in_channels, num_classes, seed=seed, device=device,
                        uniform_pool=True, **kw)
