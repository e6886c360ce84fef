"""The layers the port's models are built from, with torch-default
initialisation drawn from an explicit ``torch.Generator``, and the JAX
package's ``activation`` table (``models/blocks.py:251``).

Modules are created uninitialised (``skip_init``, so the global RNG is never
touched) and then initialised as ``torch.nn`` would: weights
kaiming-uniform with ``a = sqrt(5)``, biases uniform in +-1/sqrt(fan_in).
BatchNorm is the JAX package's ``models/blocks.BatchNorm``: eps 1e-5, train
mode through ``ops/fused_bn.bn_train`` with flax's running-stat update, over
NCHW maps or (N, C) features.

Every conv the helpers build is a ``Conv2d`` / ``ConvTranspose2d``: under
``parallel.halo.spatial_partitioning`` a conv first takes its padding rows
from its neighbours in H and convolves without padding in H, as the JAX
``Conv`` does; outside the context they are ``nn.Conv2d`` /
``nn.ConvTranspose2d`` unchanged.

The generic blocks of the JAX library (``models/blocks.py:240-397``):
``PReLU``, ``ConvBNAct``, ``DoubleConv``, ``SqueezeExcitation``,
``AttentionGate``, ``ASPP``, ``SeparableConv``, with JAX's fields and
defaults; their input channels are arguments here (JAX infers them), and
``utils/convert.layer_map`` carries their weights from the JAX blocks.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.fused_bn import bn_train
from ..parallel.halo import current_spatial_axis, halo_exchange

BN_EPS = 1e-5


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that exchanges its own padding rows with its H
    neighbours under spatial partitioning (zeros at the image's border,
    as its zero padding), then convolves with no padding in H."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = current_spatial_axis()
        if axis is None or isinstance(self.padding, str) or \
                self.padding[0] == 0:
            return super().forward(x)
        if x.shape[2] % self.stride[0]:
            raise ValueError(f"shard height {x.shape[2]} not divisible by "
                             f"the H-stride {self.stride[0]} under spatial "
                             "partitioning")
        if self.padding_mode != "zeros":
            raise NotImplementedError("spatial partitioning takes zero "
                                      "padding only")
        ph, pw = self.padding
        x = halo_exchange(x, ph, axis, dim=2)
        return F.conv2d(x, self.weight, self.bias, self.stride, (0, pw),
                        self.dilation, self.groups)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d``; under spatial partitioning only the
    non-overlapping form (kernel == stride, no padding), a local op, is
    admitted."""

    def forward(self, x: torch.Tensor, output_size=None) -> torch.Tensor:
        if current_spatial_axis() is not None and not (
                self.kernel_size == self.stride and self.padding == (0, 0)
                and self.output_padding == (0, 0)):
            raise NotImplementedError(
                "spatial partitioning supports only k==s, p==0 transpose "
                "convs")
        return super().forward(x, output_size)


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
    return _init_(skip_init(Conv2d, cin, cout, kernel_size, stride=stride,
                            padding=padding, dilation=dilation, groups=groups,
                            bias=bias), generator)


def he_conv(cin: int, cout: int, kernel_size: int, stride: int = 1,
            padding: int = 0, *, generator: torch.Generator) -> nn.Conv2d:
    """A bias-free conv with weights N(0, 2 / fan_in) (the JAX package's
    ``kaiming_normal_init``), as the ResNet and Res2Net backbones draw
    them."""
    return redraw(skip_init(Conv2d, cin, cout, kernel_size, stride=stride,
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
    return _init_(skip_init(ConvTranspose2d, cin, cout, kernel_size,
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
    return _init_(skip_init(Conv2d, cin, cout, kernel,
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


# ---------------------------------------------------------------------------
# the generic blocks (JAX ``models/blocks.py:240-397``)
# ---------------------------------------------------------------------------


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator()


class PReLU(nn.PReLU):
    """torch-default PReLU: one shared slope, 0.25 at init (JAX's
    ``alpha``)."""

    def __init__(self):
        super().__init__(num_parameters=1, init=0.25)


class ConvBNAct(nn.Module):
    """conv -> BatchNorm (train mode on K6) -> activation, the zoo's
    block; ``act`` names an entry of ``ACTIVATIONS``."""

    def __init__(self, cin: int, features: int, kernel_size=3,
                 strides: int = 1, padding=1, act: str = "relu",
                 use_bn: bool = True, use_bias: bool = True,
                 kernel_dilation: int = 1, feature_group_count: int = 1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv = conv(cin, features, kernel_size, strides, padding,
                         kernel_dilation, feature_group_count, use_bias,
                         generator=_generator(generator))
        self.bn = BatchNorm(features) if use_bn else None
        self.act = activation(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return self.act(x)


class DoubleConv(nn.Module):
    """(conv-BN-act) x 2, the standard U-Net stage."""

    def __init__(self, cin: int, features: int, act: str = "relu",
                 kernel_size: int = 3, padding: int = 1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = _generator(generator)
        self.blocks = nn.ModuleList(
            ConvBNAct(c, features, kernel_size, 1, padding, act, generator=g)
            for c in (cin, features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block(x)
        return x


class SqueezeExcitation(nn.Module):
    """SE channel gate: global average pool -> FC to C/ratio -> ReLU -> FC
    -> sigmoid -> scale."""

    def __init__(self, channels: int, ratio: int = 8, use_bias: bool = True,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        g = _generator(generator)
        hidden = max(channels // ratio, 1)
        self.fc1 = linear(channels, hidden, g, bias=use_bias)
        self.fc2 = linear(hidden, channels, g, bias=use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


class AttentionGate(nn.Module):
    """The Attention-U-Net gate (Oktay et al.):
    x * sigmoid(BN(psi(relu(BN(W_g g) + BN(W_x x))))), 1x1 convs."""

    def __init__(self, f_g: int, f_x: int, f_int: int, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = _generator(generator)
        self.w_g = ConvBNAct(f_g, f_int, 1, 1, 0, "none", generator=g)
        self.w_x = ConvBNAct(f_x, f_int, 1, 1, 0, "none", generator=g)
        self.psi = ConvBNAct(f_int, 1, 1, 1, 0, "none", generator=g)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        psi = self.psi(F.relu(self.w_g(g) + self.w_x(x)))
        return x * torch.sigmoid(psi)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: the dilated 3x3 conv-BN branches
    summed, then a 1x1 projection."""

    def __init__(self, cin: int, features: int,
                 dilations=(1, 6, 12, 18), *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = _generator(generator)
        self.branches = nn.ModuleList(
            ConvBNAct(cin, features, 3, 1, d, "none", kernel_dilation=d,
                      generator=g) for d in dilations)
        self.project = conv(features, features, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for branch in self.branches:
            y = branch(x)
            acc = y if acc is None else acc + y
        return self.project(acc)


class SeparableConv(nn.Module):
    """Depthwise conv (``kernel_size``, ``strides``, ``padding``) then a
    pointwise 1x1 conv."""

    def __init__(self, cin: int, features: int, kernel_size: int = 3,
                 strides: int = 1, padding: int = 1, use_bias: bool = False,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        g = _generator(generator)
        self.depthwise = conv(cin, cin, kernel_size, strides, padding,
                              groups=cin, bias=use_bias, generator=g)
        self.pointwise = conv(cin, features, 1, bias=use_bias, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))
