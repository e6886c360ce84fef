"""The layers the U-Net and ReLayNet are built from, with torch-default
initialisation drawn from an explicit ``torch.Generator``.

Modules are created uninitialised (``skip_init``, so the global RNG is never
touched) and then initialised as ``torch.nn`` would: weights
kaiming-uniform with ``a = sqrt(5)``, biases uniform in +-1/sqrt(fan_in).
BatchNorm is the JAX package's ``models/blocks.BatchNorm``: eps 1e-5, train
mode through ``ops/fused_bn.bn_train`` with flax's running-stat update.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.fused_bn import bn_train

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


def conv_same(cin: int, cout: int, kernel: tuple[int, int],
              generator: torch.Generator) -> nn.Conv2d:
    """Stride-1 'same' conv with bias and an odd kernel (kh, kw)."""
    kh, kw = kernel
    return _init_(skip_init(nn.Conv2d, cin, cout, kernel,
                            padding=((kh - 1) // 2, (kw - 1) // 2)), generator)


def conv_transpose2x2(cin: int, cout: int,
                      generator: torch.Generator) -> nn.ConvTranspose2d:
    """2x2 stride-2 transposed conv with bias."""
    return _init_(
        skip_init(nn.ConvTranspose2d, cin, cout, 2, stride=2), generator
    )


def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """Flax's update (``_FusedTrainBN``): 0.9 * old + 0.1 * batch, with the
    biased batch variance (``nn.BatchNorm2d`` would use the unbiased one)."""
    with torch.no_grad():
        bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
        bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)


class BatchNorm(nn.BatchNorm2d):
    """``BatchNorm2d`` (NCHW, eps 1e-5, same state-dict names) computed as
    the JAX package's: train mode runs ``bn_train`` on the channels-last
    view (K6 statistics) and updates the running stats once per call with
    ``update_running_stats``; eval mode normalises in float32 and returns
    the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).to(x.dtype)
        y, mean, var = bn_train(x.permute(0, 2, 3, 1), self.weight,
                                self.bias)
        update_running_stats(self, mean, var)
        return y.permute(0, 3, 1, 2)


def batch_norm(c: int) -> BatchNorm:
    return BatchNorm(c)
