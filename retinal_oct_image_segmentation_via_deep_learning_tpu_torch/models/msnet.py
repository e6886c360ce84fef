"""MSNet and M2SNet, the multi-scale subtraction networks (the JAX
package's ``models/msnet.py``; reference
``SOTAS/Layers_Segment/M2SNet_2021.py``), NCHW.

- ``Res2Net50Features`` gives five maps; each of x2..x5 is projected to 64
  channels by a ``ConvBR`` (3x3 conv with bias, BN, ReLU).
- A subtraction unit is ``|up(hi) - lo|`` with ``up`` the bilinear resize
  (align_corners=False) to ``lo``'s size; M2SNet adds
  ``|c3(up(hi)) - c3(lo)| + |c5(up(hi)) - c5(lo)|`` with ``c3`` and
  ``c5`` one depthwise 3x3 / 5x5 conv-BN-ReLU each (``CNN1``), shared by
  every unit: in train mode each of their four calls a unit updates the
  running statistics in turn, in the call order of JAX.
- The pyramid of units and the top-down decoder follow JAX's order of
  modules (22 ``ConvBR``), then a 3x3 head and a resize to the input.
- ``LossNet``: the frozen perceptual loss, VGG-16 ``features[:23]`` in
  four slices (random weights, as in JAX), the mean squared difference of
  each slice's features summed.

The stem conv takes ``in_channels`` (the JAX model takes the input's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import max_pool
from ..ops.resize import resize_bilinear_nchw
from .blocks import BatchNorm, conv
from .res2net import Res2Net50Features

# the pyramid's subtraction units in JAX's order: (output, hi, lo)
UNITS = (("x5_4", "dem5", "dem4"), ("x4_3", "dem4", "dem3"),
         ("x3_2", "dem3", "dem2"), ("x2_1", "dem2", "x1"),
         ("x5_4_3", "x5_4", "x4_3"), ("x4_3_2", "x4_3", "x3_2"),
         ("x3_2_1", "x3_2", "x2_1"), ("x5_4_3_2", "x5_4_3", "x4_3_2"),
         ("x4_3_2_1", "x4_3_2", "x3_2_1"))


class ConvBR(nn.Module):
    def __init__(self, cin: int, features: int = 64, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = conv(cin, features, 3, 1, 1, generator=generator)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


class CNN1(nn.Module):
    """A depthwise k x k conv (with bias) -> BN -> ReLU."""

    def __init__(self, c: int, k: int, pad: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.conv = conv(c, c, k, 1, pad, groups=c, generator=generator)
        self.bn = BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


def _up(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return resize_bilinear_nchw(x, like.shape[-2:])


class MSNet(nn.Module):
    """MSNet, or M2SNet with ``multi_kernel``."""

    def __init__(self, in_channels: int = 3, num_classes: int = 1,
                 multi_kernel: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.multi_kernel = multi_kernel
        self.backbone = Res2Net50Features(in_channels, generator=g)
        if multi_kernel:
            self.conv_3 = CNN1(64, 3, 1, generator=g)
            self.conv_5 = CNN1(64, 5, 2, generator=g)
        # dem5, dem4, dem3, dem2, the 14 units and levels, x5_dem_5 (on
        # x5) and the three decoder convs, in JAX's order
        cins = (2048, 1024, 512, 256) + (64,) * 14 + (2048,) + (64,) * 3
        self.convbr = nn.ModuleList(ConvBR(c, generator=g) for c in cins)
        self.head = conv(64, num_classes, 3, 1, 1, generator=g)

    def sub(self, hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
        hi_up = _up(hi, lo)
        d = (hi_up - lo).abs()
        if self.multi_kernel:
            d = d + (self.conv_3(hi_up) - self.conv_3(lo)).abs()
            d = d + (self.conv_5(hi_up) - self.conv_5(lo)).abs()
        return d

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2, x3, x4, x5 = self.backbone(x)
        cb = iter(self.convbr)
        m = {"x1": x1}
        for name, t in (("dem5", x5), ("dem4", x4), ("dem3", x3),
                        ("dem2", x2)):
            m[name] = next(cb)(t)
        for name, hi, lo in UNITS:
            m[name] = next(cb)(self.sub(m[hi], m[lo]))
        x5_dem_4 = next(cb)(m["x5_4_3_2"])
        x5_4_3_2_1 = next(cb)(self.sub(x5_dem_4, m["x4_3_2_1"]))
        level4 = m["x5_4"]
        level3 = next(cb)(m["x4_3"] + m["x5_4_3"])
        level2 = next(cb)(m["x3_2"] + m["x4_3_2"] + m["x5_4_3_2"])
        level1 = next(cb)(m["x2_1"] + m["x3_2_1"] + m["x4_3_2_1"]
                          + x5_4_3_2_1)
        out = next(cb)(x5)  # x5_dem_5
        for level in (level4, level3, level2):
            out = next(cb)(_up(out, level) + level)
        out = self.head(_up(out, level1) + level1)
        return resize_bilinear_nchw(out, x.shape[-2:])


class VGG16Slices(nn.Module):
    """VGG-16 ``features[:23]`` cut at 4, 9, 16 and 23: the four slices'
    outputs."""

    CFG = ((64, 64), (128, 128), (256, 256, 256), (512, 512, 512))

    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        cin, convs = 3, []
        for widths in self.CFG:
            for c in widths:
                convs.append(conv(cin, c, 3, 1, 1, generator=generator))
                cin = c
        self.convs = nn.ModuleList(convs)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        feats, convs, h = [], iter(self.convs), x
        for i, widths in enumerate(self.CFG):
            if i:
                h = max_pool(h, 2)
            for _ in widths:
                h = F.relu(next(convs)(h))
            feats.append(h)
        return feats


class LossNet(nn.Module):
    """The perceptual loss of two NCHW images (1 or 3 channels): each
    tiled to three channels, normalised with the ImageNet mean and std,
    resized to 224x224 (``resize``), through one ``VGG16Slices``; the sum
    over the slices of the mean squared difference, in float32."""

    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)

    def __init__(self, resize: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.resize = resize
        self.vgg = VGG16Slices(generator=generator if generator is not None
                               else torch.Generator())

    def prep(self, t: torch.Tensor) -> torch.Tensor:
        if t.shape[1] != 3:
            t = t.repeat(1, 3, 1, 1)
        mean = torch.tensor(self.MEAN, device=t.device).view(1, 3, 1, 1)
        std = torch.tensor(self.STD, device=t.device).view(1, 3, 1, 1)
        t = (t - mean) / std
        return resize_bilinear_nchw(t, (224, 224)) if self.resize else t

    def forward(self, inputs: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
        loss = 0.0
        for a, b in zip(self.vgg(self.prep(inputs)),
                        self.vgg(self.prep(target))):
            loss = loss + torch.mean((a.float() - b.float()) ** 2)
        return loss


def build_msnet(in_channels: int = 3, num_classes: int = 1, *,
                seed: int = 0, device: torch.device | str = "cpu",
                **kw) -> MSNet:
    """MSNet initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = MSNet(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()


def build_m2snet(in_channels: int = 3, num_classes: int = 1, *,
                 seed: int = 0, device: torch.device | str = "cpu",
                 **kw) -> MSNet:
    """M2SNet (MSNet with the shared multi-kernel units) initialised on
    the CPU from ``seed``, then moved to ``device``; eval mode."""
    return build_msnet(in_channels, num_classes, seed=seed, device=device,
                       multi_kernel=True, **kw)
