"""The layers the port's models are built from, with torch-default
initialisation drawn from an explicit ``torch.Generator``, and the JAX
package's ``activation`` table (``models/blocks.py:251``).

Modules are created uninitialised (``skip_init``, so the global RNG is never
touched) and then initialised as ``torch.nn`` would: weights
kaiming-uniform with ``a = sqrt(5)``, biases uniform in +-1/sqrt(fan_in).
BatchNorm is the JAX package's ``models/blocks.BatchNorm``: eps 1e-5, train
mode through ``ops/fused_bn.bn_train`` with flax's running-stat update, over
NCHW maps or (N, C) features.
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


def redraw(m: nn.Module, std: float, generator: torch.Generator,
           truncated: bool = False) -> nn.Module:
    """``m``, made uninitialised (``skip_init``), with weights N(0, std^2)
    (``truncated``: cut at +-2 std) and zero biases, for the JAX models
    whose initialisers are not torch's."""
    with torch.no_grad():
        if truncated:
            nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        else:
            m.weight.normal_(0.0, std, generator=generator)
        if m.bias is not None:
            m.bias.zero_()
    return m


def conv(cin: int, cout: int, kernel_size, stride: int = 1,
         padding=0, dilation: int = 1, groups: int = 1,
         bias: bool = True, *, generator: torch.Generator) -> nn.Conv2d:
    """Any conv with zero padding (the JAX ``Conv``); ``kernel_size`` and
    ``padding`` an int or an (h, w) pair."""
    return _init_(skip_init(nn.Conv2d, cin, cout, kernel_size, stride=stride,
                            padding=padding, dilation=dilation, groups=groups,
                            bias=bias), generator)


def he_conv(cin: int, cout: int, kernel_size: int, stride: int = 1,
            padding: int = 0, *, generator: torch.Generator) -> nn.Conv2d:
    """A bias-free conv with weights N(0, 2 / fan_in) (the JAX package's
    ``kaiming_normal_init``), as the ResNet and Res2Net backbones draw
    them."""
    return redraw(skip_init(nn.Conv2d, cin, cout, kernel_size, stride=stride,
                            padding=padding, bias=False),
                  math.sqrt(2.0 / (cin * kernel_size ** 2)), generator)


def conv_transpose(cin: int, cout: int, kernel_size: int, stride: int = 2,
                   padding: int = 0, output_padding: int = 0,
                   bias: bool = True, *,
                   generator: torch.Generator) -> nn.ConvTranspose2d:
    """torch's ``ConvTranspose2d``: the JAX ``ConvTranspose`` (an
    input-dilated conv with the flipped kernel, padded k - 1 - p and
    k - 1 - p + output_padding), whose (k, k, in, out) kernel is this
    layer's (in, out, k, k) weight."""
    return _init_(skip_init(nn.ConvTranspose2d, cin, cout, kernel_size,
                            stride=stride, padding=padding,
                            output_padding=output_padding, bias=bias),
                  generator)


def conv3x3(cin: int, cout: int, generator: torch.Generator) -> nn.Conv2d:
    """3x3 stride-1 'same' conv without bias."""
    return conv(cin, cout, 3, padding=1, bias=False, generator=generator)


def conv1x1(cin: int, cout: int, generator: torch.Generator) -> nn.Conv2d:
    """1x1 conv with bias (the classifier head)."""
    return conv(cin, cout, 1, generator=generator)


def conv_same(cin: int, cout: int, kernel: tuple[int, int],
              generator: torch.Generator) -> nn.Conv2d:
    """Stride-1 'same' conv with bias and an odd kernel (kh, kw)."""
    kh, kw = kernel
    return _init_(skip_init(nn.Conv2d, cin, cout, kernel,
                            padding=((kh - 1) // 2, (kw - 1) // 2)), generator)


def conv3x3_stride2(cin: int, cout: int,
                    generator: torch.Generator) -> nn.Conv2d:
    """3x3 stride-2 conv with bias and padding 1."""
    return conv(cin, cout, 3, 2, 1, generator=generator)


def linear(cin: int, cout: int, generator: torch.Generator,
           bias: bool = True) -> nn.Linear:
    """Dense layer, with bias unless ``bias`` is false."""
    return _init_(skip_init(nn.Linear, cin, cout, bias=bias), generator)


def conv_transpose2x2(cin: int, cout: int,
                      generator: torch.Generator) -> nn.ConvTranspose2d:
    """2x2 stride-2 transposed conv with bias."""
    return conv_transpose(cin, cout, 2, 2, generator=generator)


ACTIVATIONS = {
    "relu": F.relu,
    "leaky_relu": lambda x: F.leaky_relu(x, 0.01),
    "leaky_relu_0.2": lambda x: F.leaky_relu(x, 0.2),
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu
    "none": lambda x: x,
}


def activation(name: str):
    """The elementwise activation named as in the JAX package."""
    return ACTIVATIONS[name]


def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor,
                         var: torch.Tensor) -> None:
    """Flax's update (``_FusedTrainBN``): 0.9 * old + 0.1 * batch, with the
    biased batch variance (``nn.BatchNorm2d`` would use the unbiased one)."""
    with torch.no_grad():
        bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * mean)
        bn.running_var.copy_(0.9 * bn.running_var + 0.1 * var)


class BatchNorm(nn.BatchNorm2d):
    """``BatchNorm2d`` (eps 1e-5, same state-dict names) over the channel
    axis 1 of an NCHW map or of (N, C) features, computed as the JAX
    package's: train mode runs ``bn_train`` on the channels-last view (K6
    statistics) and updates the running stats once per call with
    ``update_running_stats``; eval mode normalises in float32 and returns
    the input's dtype."""

    def __init__(self, num_features: int):
        super().__init__(num_features, eps=BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).to(x.dtype)
        y, mean, var = bn_train(x.movedim(1, -1), self.weight, self.bias)
        update_running_stats(self, mean, var)
        return y.movedim(-1, 1)


def batch_norm(c: int) -> BatchNorm:
    return BatchNorm(c)
