"""BioNet, knowledge-infused choroid segmentation (the JAX package's
``models/bionet.py``; reference ``SOTAS/Layers_Segment/BioNet_2020.py``),
NCHW.

- ``BioUNet``: the reference's internal U-Net, four encoder blocks (64 ...
  512; each (3x3 conv with bias, BN, ReLU) x 2, 2x2 max-pools between),
  three decoder blocks after 2x2 transposed convs on ``[skip, up]``, a 1x1
  head.
- ``BioNet``: a GMS U-Net of ``gms_channels`` outputs on the input, an LCS
  U-Net of ``num_classes`` on ``[x, gms]``, and ``BioRegularization`` on
  ``[x, seg]``: a 1x1 conv to 3 channels, ``ResNetFeatures`` (ResNet-18),
  the global average and a Dense(1).

The forward returns the tuple ``(seg_pred, gms_out, bio_out)``, as JAX's;
neither package has a trainer or loss for it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import max_pool
from .blocks import BatchNorm, conv, conv_transpose2x2, linear
from .resnet import ResNetFeatures


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = conv(cin, features, 3, 1, 1, generator=g)
        self.bn1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, 1, 1, generator=g)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class BioUNet(nn.Module):
    def __init__(self, cin: int, out_channels: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.encoders = nn.ModuleList(
            ConvBlock(a, b, generator=g)
            for a, b in ((cin, 64), (64, 128), (128, 256), (256, 512)))
        self.ups = nn.ModuleList(conv_transpose2x2(a, a // 2, generator=g)
                                 for a in (512, 256, 128))
        self.decoders = nn.ModuleList(ConvBlock(a, a // 2, generator=g)
                                      for a in (512, 256, 128))
        self.head = conv(64, out_channels, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = []
        for i, enc in enumerate(self.encoders):
            x = enc(x if i == 0 else max_pool(x, 2))
            skips.append(x)
        for skip, up, dec in zip(skips[2::-1], self.ups, self.decoders):
            x = dec(torch.cat([skip, up(x)], dim=1))
        return self.head(x)


class BioRegularization(nn.Module):
    def __init__(self, cin: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.proj = conv(cin, 3, 1, generator=g)
        self.resnet = ResNetFeatures(3, generator=g)
        self.fc = linear(512, 1, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc(self.resnet(self.proj(x)).mean(dim=(2, 3)))


class BioNet(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 1,
                 gms_channels: int = 2, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.gms = BioUNet(in_channels, gms_channels, generator=g)
        self.lcs = BioUNet(in_channels + gms_channels, num_classes,
                           generator=g)
        self.bio = BioRegularization(in_channels + num_classes, generator=g)

    def forward(self, x: torch.Tensor):
        gms_out = self.gms(x)
        seg_pred = self.lcs(torch.cat([x, gms_out], dim=1))
        bio_out = self.bio(torch.cat([x, seg_pred], dim=1))
        return seg_pred, gms_out, bio_out


def build_bionet(in_channels: int = 1, num_classes: int = 1,
                 gms_channels: int = 2, *, seed: int = 0,
                 device: torch.device | str = "cpu", **kw) -> BioNet:
    """BioNet initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = BioNet(in_channels, num_classes, gms_channels, generator=g, **kw)
    return model.to(device).eval()
