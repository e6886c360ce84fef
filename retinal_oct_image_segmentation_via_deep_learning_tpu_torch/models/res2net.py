"""Res2Net-50 v1b (26w x 4s), the backbone of MSNet and M2SNet (the JAX
package's ``models/res2net.py``), NCHW.

- deep stem: three 3x3 convs (32, 32, 64) at strides 2, 1, 1, each with
  BN and ReLU, then ``max_pool(3, 2, padding=1)``;
- ``Bottle2neck``: a 1x1 to width * scale (width = planes * 26 / 64,
  scale 4), split in four along the channels; the first three splits go
  through a 3x3 conv-BN-ReLU each, every split after the first added to
  the previous split's output unless the block is a 'stage' block (one
  with a downsample); a stage block's last split is average-pooled
  (3x3, zero padding counted, in float32) where it strides and taken as
  it is at stride 1, as in JAX (the published Res2Net pools it at stride
  1 too); then a 1x1 expansion x4 with BN;
- v1b downsample: ``avg_pool(stride)`` (floor) -> 1x1 conv -> BN.

Convs are bias-free and He-normal (fan in), as in JAX.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import avg_pool, max_pool
from .blocks import BatchNorm, he_conv

STAGES = (3, 4, 6, 3)


def _avg_pool_pad(x: torch.Tensor, k: int, stride: int,
                  padding: int) -> torch.Tensor:
    """k x k average pool after zero padding, the padding counted (the
    sum divided by k^2), in float32 and returned in x's dtype."""
    return F.avg_pool2d(x.float(), k, stride, padding,
                        count_include_pad=True).to(x.dtype)


class Bottle2neck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int = 1,
                 downsample: bool = False, base_width: int = 26,
                 scale: int = 4, *, generator: torch.Generator):
        super().__init__()
        g = generator
        width = int(planes * base_width / 64.0)
        self.stride, self.stage, self.width = stride, downsample, width
        self.conv1 = he_conv(cin, width * scale, 1, generator=g)
        self.bn1 = BatchNorm(width * scale)
        self.convs = nn.ModuleList(
            he_conv(width, width, 3, stride, 1, generator=g)
            for _ in range(scale - 1))
        self.bns = nn.ModuleList(BatchNorm(width) for _ in range(scale - 1))
        self.conv3 = he_conv(width * scale, planes * 4, 1, generator=g)
        self.bn3 = BatchNorm(planes * 4)
        self.down = self.down_bn = None
        if downsample:
            self.down = he_conv(cin, planes * 4, 1, generator=g)
            self.down_bn = BatchNorm(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        splits = torch.split(F.relu(self.bn1(self.conv1(x))), self.width,
                             dim=1)
        outs, sp = [], None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if i == 0 or self.stage else sp + splits[i]
            sp = F.relu(bn(conv(sp)))
            outs.append(sp)
        last = splits[-1]
        if self.stage and self.stride > 1:
            last = _avg_pool_pad(last, 3, self.stride, 1)
        out = self.bn3(self.conv3(torch.cat(outs + [last], dim=1)))
        identity = x
        if self.down is not None:
            if self.stride > 1:
                identity = avg_pool(x, self.stride)
            identity = self.down_bn(self.down(identity))
        return F.relu(out + identity)


class Res2Net50Features(nn.Module):
    """The stem and layer1..4 -> [x1 (after the max-pool), x2, x3, x4,
    x5], the five maps MSNet reads."""

    def __init__(self, in_channels: int = 3, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.stem = nn.ModuleList([he_conv(in_channels, 32, 3, 2, 1,
                                           generator=g),
                                   he_conv(32, 32, 3, 1, 1, generator=g),
                                   he_conv(32, 64, 3, 1, 1, generator=g)])
        self.stem_bns = nn.ModuleList(BatchNorm(c) for c in (32, 32, 64))
        self.layers = nn.ModuleList()
        cin = 64
        for i, n_blocks in enumerate(STAGES):
            planes, blocks = 64 * 2 ** i, []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                down = j == 0 and (stride != 1 or cin != planes * 4)
                blocks.append(Bottle2neck(cin, planes, stride, down,
                                          generator=g))
                cin = planes * 4
            self.layers.append(nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        h = x
        for conv, bn in zip(self.stem, self.stem_bns):
            h = F.relu(bn(conv(h)))
        out = [max_pool(h, 3, 2, padding=1)]
        for layer in self.layers:
            out.append(layer(out[-1]))
        return out
