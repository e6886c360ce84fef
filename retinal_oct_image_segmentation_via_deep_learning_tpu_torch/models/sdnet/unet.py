"""SD_Layer_Net's U-Net backbones (the JAX package's
``models/sdnet/unet.py``), NCHW.

``UNetBackbone``: a ``ResConvBlock`` per level with a 2x2 max-pool between
levels; on the way up an ``UpConv``, the skip (through an ``AttentionGate``
when ``attention``), ``cat([skip, up])`` and a ``ResConvBlock``; a 1x1 head.
SDNet builds it with attention and five levels (the JAX ``AttU_Net``).

``U_Net``, ``AttU_Net`` and ``AttU_Net4`` are SD_Layer_Net's public
builders, with JAX's defaults (``models/sdnet/unet.py:54-66``): seeded on
the CPU, then moved to ``device``, in eval mode. ``drop_rate`` is JAX's
channel dropout (``common.ResConvBlock``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ...ops.pooling import max_pool
from ..blocks import conv1x1
from .common import AttentionGate, ResConvBlock, UpConv


class UNetBackbone(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 channels: Sequence[int] = (64, 128, 256, 512, 1024),
                 attention: bool = False, drop_rate: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        g, chans, d = generator, list(channels), drop_rate
        self.enc = nn.ModuleList(
            ResConvBlock(cin, c, 3, d, generator=g)
            for cin, c in zip([in_channels] + chans[:-1], chans))
        ups = range(len(chans) - 2, -1, -1)  # decoder levels, deepest first
        self.up = nn.ModuleList(
            UpConv(chans[lvl + 1], chans[lvl], d, generator=g)
            for lvl in ups)
        self.att = nn.ModuleList(
            AttentionGate(chans[lvl], chans[lvl], chans[lvl] // 2,
                          generator=g) for lvl in ups) if attention else None
        self.dec = nn.ModuleList(
            ResConvBlock(2 * chans[lvl], chans[lvl], 3, d, generator=g)
            for lvl in ups)
        self.head = conv1x1(chans[0], out_channels, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, h = [], x
        for i, block in enumerate(self.enc):
            h = block(max_pool(h, 2) if i else h)
            skips.append(h)
        for k, (up, dec) in enumerate(zip(self.up, self.dec)):
            h = up(h)
            skip = skips[-2 - k]
            if self.att is not None:
                skip = self.att[k](h, skip)
            h = dec(torch.cat([skip, h], dim=1))
        return self.head(h)


def _backbone(output_ch, channels, attention, drop_rate, in_channels, seed,
              device) -> UNetBackbone:
    g = torch.Generator().manual_seed(seed)
    model = UNetBackbone(in_channels, output_ch, tuple(channels), attention,
                         drop_rate, generator=g)
    return model.to(device).eval()


def U_Net(output_ch=1, channels=(64, 128, 256, 512, 1024), drop_rate=0.0,
          *, in_channels: int = 1, seed: int = 0,
          device: torch.device | str = "cpu") -> UNetBackbone:
    """The residual U-Net, without attention gates."""
    return _backbone(output_ch, channels, False, drop_rate, in_channels,
                     seed, device)


def AttU_Net(output_ch=1, channels=(64, 128, 256, 512, 1024), drop_rate=0.0,
             *, in_channels: int = 1, seed: int = 0,
             device: torch.device | str = "cpu") -> UNetBackbone:
    """The U-Net with an attention gate on every skip."""
    return _backbone(output_ch, channels, True, drop_rate, in_channels,
                     seed, device)


def AttU_Net4(output_ch=1, channels=(64, 128, 256, 512), drop_rate=0.0,
              *, in_channels: int = 1, seed: int = 0,
              device: torch.device | str = "cpu") -> UNetBackbone:
    """``AttU_Net`` with four levels."""
    return _backbone(output_ch, channels, True, drop_rate, in_channels,
                     seed, device)
