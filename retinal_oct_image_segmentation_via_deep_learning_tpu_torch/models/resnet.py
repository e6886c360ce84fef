"""ResNet backbones, torchvision's module structure up to (not including)
the average pool and the classifier (the JAX package's
``models/resnet.py``), NCHW: a 7x7 stride-2 stem (padding 3) with BN and
ReLU, ``max_pool(3, 2, padding=1)``, then four stages of ``BasicBlock``
(ResNet-18, the default) or ``Bottleneck`` (x4 expansion), the first block
of stages 2-4 at stride 2, a 1x1 conv-BN downsample where the shape
changes. Convs are bias-free and He-normal (fan in), as in JAX.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import max_pool
from .blocks import BatchNorm, he_conv


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = he_conv(cin, features, 3, stride, 1, generator=g)
        self.bn1 = BatchNorm(features)
        self.conv2 = he_conv(features, features, 3, 1, 1, generator=g)
        self.bn2 = BatchNorm(features)
        self.down = self.down_bn = None
        if downsample:
            self.down = he_conv(cin, features, 1, stride, generator=g)
            self.down_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        identity = x if self.down is None else self.down_bn(self.down(x))
        return F.relu(h + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, *, generator: torch.Generator):
        super().__init__()
        g, f = generator, features
        self.conv1 = he_conv(cin, f, 1, generator=g)
        self.bn1 = BatchNorm(f)
        self.conv2 = he_conv(f, f, 3, stride, 1, generator=g)
        self.bn2 = BatchNorm(f)
        self.conv3 = he_conv(f, f * 4, 1, generator=g)
        self.bn3 = BatchNorm(f * 4)
        self.down = self.down_bn = None
        if downsample:
            self.down = he_conv(cin, f * 4, 1, stride, generator=g)
            self.down_bn = BatchNorm(f * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        identity = x if self.down is None else self.down_bn(self.down(x))
        return F.relu(h + identity)


class ResNetFeatures(nn.Module):
    """-> the last stage's map, or with ``capture_stages`` the list [stem
    (before the max-pool), layer1, ..., layer4]."""

    def __init__(self, in_channels: int = 3,
                 stage_sizes: Sequence[int] = (2, 2, 2, 2),
                 block: str = "basic", capture_stages: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.capture_stages = capture_stages
        self.stem = he_conv(in_channels, 64, 7, 2, 3, generator=g)
        self.stem_bn = BatchNorm(64)
        Block = BasicBlock if block == "basic" else Bottleneck
        self.layers = nn.ModuleList()
        cin = 64
        for i, n_blocks in enumerate(stage_sizes):
            width, blocks = 64 * 2 ** i, []
            for j in range(n_blocks):
                stride = 2 if i > 0 and j == 0 else 1
                down = j == 0 and (stride != 1
                                   or cin != width * Block.expansion)
                blocks.append(Block(cin, width, stride, down, generator=g))
                cin = width * Block.expansion
            self.layers.append(nn.Sequential(*blocks))

    def forward(self, x: torch.Tensor):
        stem = F.relu(self.stem_bn(self.stem(x)))
        out, h = [stem], max_pool(stem, 3, 2, padding=1)
        for layer in self.layers:
            h = layer(h)
            out.append(h)
        return out if self.capture_stages else h
