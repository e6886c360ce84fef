"""SD_Layer_Net's shared blocks (the JAX package's
``models/sdnet/common.py``), NCHW.

- ``ResConvBlock``: init_conv, then conv-BN-relu-conv-BN, added to the
  init_conv output, then relu.
- ``UpConv``: bilinear (align_corners=True) x2 upsample, then conv-BN-relu.
- ``straight_through_round``: round in the forward, identity in the
  backward.
- ``AttentionGate``: the Oktay-style gate the JAX package implements (the
  reference's ``Attention_block`` cannot be constructed as written):
  x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x))))).

``drop_rate`` is JAX's ``Drop2d``: in train mode whole channels are
dropped (``F.dropout2d``) after each BatchNorm; at 0, the default of every
caller, it is the identity.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import upsample_bilinear
from ..blocks import batch_norm, conv1x1, conv_same


def straight_through_round(x: torch.Tensor) -> torch.Tensor:
    return x + (torch.round(x) - x).detach()


def _drop(x: torch.Tensor, rate: float, training: bool) -> torch.Tensor:
    return F.dropout2d(x, rate, training) if rate else x


class ResConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 drop_rate: float = 0.0, *, generator: torch.Generator):
        super().__init__()
        k, g = (kernel_size, kernel_size), generator
        self.drop_rate = drop_rate
        self.init_conv = conv_same(cin, features, k, g)
        self.conv1 = conv_same(features, features, k, g)
        self.bn1 = batch_norm(features)
        self.conv2 = conv_same(features, features, k, g)
        self.bn2 = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        init = self.init_conv(x)
        h = _drop(self.bn1(self.conv1(init)), self.drop_rate, self.training)
        h = _drop(self.bn2(self.conv2(F.relu(h))), self.drop_rate,
                  self.training)
        return F.relu(h + init)


class UpConv(nn.Module):
    def __init__(self, cin: int, features: int, drop_rate: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.drop_rate = drop_rate
        self.conv = conv_same(cin, features, (3, 3), generator)
        self.bn = batch_norm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = upsample_bilinear(x, 2)
        return F.relu(_drop(self.bn(self.conv(x)), self.drop_rate,
                            self.training))


class AttentionGate(nn.Module):
    def __init__(self, f_g: int, f_x: int, f_int: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.w_g, self.bn_g = conv1x1(f_g, f_int, g), batch_norm(f_int)
        self.w_x, self.bn_x = conv1x1(f_x, f_int, g), batch_norm(f_int)
        self.psi, self.bn_psi = conv1x1(f_int, 1, g), batch_norm(1)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = F.relu(self.bn_g(self.w_g(g)) + self.bn_x(self.w_x(x)))
        return x * torch.sigmoid(self.bn_psi(self.psi(psi)))
