"""FourierNet, the cascaded FD-regression + segmentation U-Net (the JAX
package's ``models/fouriernet.py``; reference
``Layers_Segment/FourierNet/deepModels.py``), NCHW.

A shared 4-level encoder feeds one decoder per Fourier-descriptor channel,
each ending in a linear 1-channel head (the FD maps, MSE targets); the FD
maps concatenated with the input feed a second full U-Net (``CasUNet``)
whose head is a softmax over 2 classes (linear for any other count).
Blocks are conv-ReLU-dropout-conv-ReLU, 3x3 'same' convs with He-uniform
weights and zero biases (Keras' defaults); the decoder upsamples 2x
nearest and concatenates ``[up, skip]``. ``forward`` returns
``(fd_maps list, final)``. Dropout (train mode, rate > 0) draws its mask
from the ``generator`` the caller gives and scales kept values by
1 / (1 - rate), as flax's ``Dropout``. Training:
``training/fouriernet_pipeline.FourierNetTrainer``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.pooling import max_pool
from .blocks import Conv2d


def he_conv(cin: int, cout: int, kernel_size: int) -> nn.Conv2d:
    """'same' conv with bias (odd kernel), left uninitialised for
    ``_he_init_``."""
    return skip_init(Conv2d, cin, cout, kernel_size,
                     padding=kernel_size // 2)


def _he_init_(module: nn.Module, generator: torch.Generator) -> None:
    """He-uniform weights (U(+-sqrt(6 / fan_in))), zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            nn.init.kaiming_uniform_(m.weight, a=0.0, nonlinearity="relu",
                                     generator=generator)
            nn.init.zeros_(m.bias)


def dropout(x: torch.Tensor, rate: float, training: bool,
            generator: torch.Generator | None) -> torch.Tensor:
    """flax ``Dropout``: keep with probability 1 - rate, scale kept values
    by 1 / (1 - rate); the identity in eval mode or at rate 0."""
    if not training or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class UNetBlock2(nn.Module):
    """conv-ReLU-dropout-conv-ReLU (reference ``unetOneBlock``, :7-13)."""

    def __init__(self, cin: int, features: int, rate: float = 0.2):
        super().__init__()
        self.conv1 = he_conv(cin, features, 3)
        self.conv2 = he_conv(features, features, 3)
        self.rate = rate

    def forward(self, x, generator=None):
        x = F.relu(self.conv1(x))
        x = dropout(x, self.rate, self.training, generator)
        return F.relu(self.conv2(x))


class _Encoder(nn.Module):
    def __init__(self, cin: int, features: Sequence[int], rate: float):
        super().__init__()
        chans = [cin] + list(features[:4])
        self.blocks = nn.ModuleList(
            UNetBlock2(a, b, rate) for a, b in zip(chans[:-1], chans[1:]))

    def forward(self, x, generator=None):
        skips = []
        for block in self.blocks:
            x = block(x, generator)
            skips.append(x)
            x = max_pool(x, 2)
        return skips, x


class _Decoder(nn.Module):
    def __init__(self, features: Sequence[int], rate: float):
        super().__init__()
        cin, blocks = features[4], []
        for lvl in (3, 2, 1, 0):
            blocks.append(UNetBlock2(cin + features[lvl], features[lvl],
                                     rate))
            cin = features[lvl]
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x, skips, generator=None):
        for lvl, block in zip((3, 2, 1, 0), self.blocks):
            up = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
            x = block(torch.cat([up, skips[lvl]], dim=1), generator)
        return x


class CasUNet(nn.Module):
    """The stage-2 full U-Net (reference ``CasUNet``, :43-57)."""

    def __init__(self, cin: int, out_channels: int,
                 features: Sequence[int], rate: float):
        super().__init__()
        self.encoder = _Encoder(cin, features, rate)
        self.bottleneck = UNetBlock2(features[3], features[4], rate)
        self.decoder = _Decoder(features, rate)
        self.head = he_conv(features[0], out_channels, 1)
        self.out_channels = out_channels

    def forward(self, x, generator=None):
        skips, h = self.encoder(x, generator)
        h = self.bottleneck(h, generator)
        logits = self.head(self.decoder(h, skips, generator))
        if self.out_channels == 2:
            return torch.softmax(logits, dim=1)
        return logits  # the linear head (outputNo == 1, :53-55)


class FourierNet(nn.Module):
    def __init__(self, in_channels: int = 1, fd_channel: int = 1,
                 features: Sequence[int] = (16, 32, 64, 128, 256),
                 dropout: float = 0.2, final_classes: int = 2, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        features = tuple(features)
        self.encoder = _Encoder(in_channels, features, dropout)
        self.bottleneck = UNetBlock2(features[3], features[4], dropout)
        self.decoders = nn.ModuleList(
            _Decoder(features, dropout) for _ in range(fd_channel))
        self.fd_heads = nn.ModuleList(
            he_conv(features[0], 1, 1) for _ in range(fd_channel))
        self.cas = CasUNet(in_channels + fd_channel, final_classes,
                           features, dropout)
        _he_init_(self, generator if generator is not None
                  else torch.Generator())

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None):
        """-> (list of fd_channel (N, 1, H, W) FD maps, (N, C, H, W)
        class probabilities); ``generator`` draws the dropout masks in
        train mode."""
        skips, pooled = self.encoder(x, generator)
        bott = self.bottleneck(pooled, generator)
        fd_maps = [head(dec(bott, skips, generator))
                   for dec, head in zip(self.decoders, self.fd_heads)]
        final = self.cas(torch.cat([x] + fd_maps, dim=1), generator)
        return fd_maps, final


def build_fouriernet(in_channels: int = 1, num_classes: int = 2,
                     fd_channel: int = 1, *, seed: int = 0,
                     device: torch.device | str = "cpu",
                     **kw) -> FourierNet:
    """FourierNet initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = FourierNet(in_channels, fd_channel, final_classes=num_classes,
                       generator=g, **kw)
    return model.to(device).eval()
