"""WAT-Net, the wavelet-attention U-Net (the JAX package's
``models/watnet.py``; reference ``SOTAS/Layers_Segment/WAT_SegNet_2022.py``),
NCHW.

- ``X2Conv``: (3x3 conv without bias, BN, ReLU) x 2, the inner width half
  the output's.
- ``WAT``: the Haar DWT of the map in float32, the spatial mean of
  cA + cH, Dense -> ReLU -> Dense -> sigmoid, the gate on the map's
  channels.
- ``WATNet``: a U-Net of 64 ... 1024 with a WAT after each encoder level
  and each decoder block. The decoder reuses the encoder's four WATs (one
  module a width, called twice: its weights once in the state dict, both
  uses adding to its gradient).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dwt import haar_dwt2d
from ..ops.pooling import max_pool
from .blocks import BatchNorm, conv, conv_transpose2x2, linear


class X2Conv(nn.Module):
    def __init__(self, cin: int, features: int, inner: int | None = None, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        inner = features // 2 if inner is None else inner
        self.conv1 = conv(cin, inner, 3, 1, 1, bias=False, generator=g)
        self.bn1 = BatchNorm(inner)
        self.conv2 = conv(inner, features, 3, 1, 1, bias=False, generator=g)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


class WAT(nn.Module):
    def __init__(self, c: int, reduction_ratio: int = 2, *,
                 generator: torch.Generator):
        super().__init__()
        self.fc1 = linear(c, c // reduction_ratio, generator)
        self.fc2 = linear(c // reduction_ratio, c, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ca, ch, _, _ = haar_dwt2d(x.float())
        squeeze = (ca + ch).mean(dim=(2, 3)).to(x.dtype)  # (B, C)
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(squeeze))))
        return x * s[:, :, None, None]


class WATNet(nn.Module):
    WIDTHS = (64, 128, 256, 512, 1024)

    def __init__(self, in_channels: int = 3, num_classes: int = 4, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        w = self.WIDTHS
        self.start_conv = X2Conv(in_channels, w[0], generator=g)
        self.convs = nn.ModuleList(X2Conv(a, b, generator=g)
                                   for a, b in zip(w, w[1:]))
        self.middle_conv = X2Conv(w[4], w[4], generator=g)
        self.wats = nn.ModuleList(WAT(c, generator=g) for c in w[:4])
        self.uppools = nn.ModuleList(conv_transpose2x2(c, c // 2,
                                                       generator=g)
                                     for c in w[:0:-1])
        self.dec_convs = nn.ModuleList(X2Conv(c, c // 2, generator=g)
                                       for c in w[:0:-1])
        self.final_conv = conv(w[0], num_classes, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.wats[0](self.start_conv(x))
        skips = [h]
        for i in range(3):
            h = self.wats[i + 1](self.convs[i](max_pool(h, 2)))
            skips.append(h)
        h = self.middle_conv(self.convs[3](max_pool(h, 2)))
        for i, lvl in enumerate((3, 2, 1, 0)):
            h = torch.cat([skips[lvl], self.uppools[i](h)], dim=1)
            h = self.wats[lvl](self.dec_convs[i](h))
        return self.final_conv(h)


def build_watnet(in_channels: int = 3, num_classes: int = 4, *,
                 seed: int = 0, device: torch.device | str = "cpu",
                 **kw) -> WATNet:
    """WAT-Net initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = WATNet(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()
