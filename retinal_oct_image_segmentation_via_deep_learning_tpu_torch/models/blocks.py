"""The layers the U-Net is built from, with torch-default initialisation
drawn from an explicit ``torch.Generator``.

Modules are created uninitialised (``skip_init``, so the global RNG is never
touched) and then initialised as ``torch.nn`` would: weights
kaiming-uniform with ``a = sqrt(5)``, biases uniform in +-1/sqrt(fan_in).
BatchNorm uses eps 1e-5, as the JAX package's ``models/blocks.BatchNorm``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn.utils import skip_init

BN_EPS = 1e-5


def _init_(m: nn.Module, generator: torch.Generator) -> nn.Module:
    nn.init.kaiming_uniform_(m.weight, a=math.sqrt(5), generator=generator)
    if m.bias is not None:
        # torch's fan_in: weight dim 1 times the kernel area, for Conv2d
        # (in) and ConvTranspose2d (out) alike
        bound = 1.0 / math.sqrt(m.weight[0].numel())
        nn.init.uniform_(m.bias, -bound, bound, generator=generator)
    return m


def conv3x3(cin: int, cout: int, generator: torch.Generator) -> nn.Conv2d:
    """3x3 stride-1 'same' conv without bias."""
    return _init_(
        skip_init(nn.Conv2d, cin, cout, 3, padding=1, bias=False), generator
    )


def conv1x1(cin: int, cout: int, generator: torch.Generator) -> nn.Conv2d:
    """1x1 conv with bias (the classifier head)."""
    return _init_(skip_init(nn.Conv2d, cin, cout, 1), generator)


def conv_transpose2x2(cin: int, cout: int,
                      generator: torch.Generator) -> nn.ConvTranspose2d:
    """2x2 stride-2 transposed conv with bias."""
    return _init_(
        skip_init(nn.ConvTranspose2d, cin, cout, 2, stride=2), generator
    )


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=BN_EPS)
