"""RetiFluidNet, a multi-attention U-Net for OCT fluid (the JAX package's
``models/retifluidnet.py``; reference
``SOTAS/Lesions_Segment/RetiFluidNet_pytorch_2022.py``), NCHW.

- ``SDA``, self-dual attention: a 4x max-pool to N = (H/4)(W/4) tokens of
  C channels in float32 under any autocast; the pixel attention
  softmax(X X^T / sqrt(N)) X and the channel attention
  softmax(X^T X / C) applied to X, plain float32 products and softmaxes
  as in JAX; each through a bias-free 1x1 conv (weights 1.0 at init),
  nearest-resized back; ``x + (pixel + channel) / 2``.
- ``ConvStage``: (3x3 conv with bias, BN, ReLU) x 2.
- ``RetiFluidNet``: an initial 3x3 conv, five encoder stages of
  ``base_channels`` x (1, 2, 4, 8, 16) (each ``c + SDA(c)``, 2x2 pools
  between) and four decoder stages on ``[up(d), skip]`` (bilinear,
  align_corners). Deep supervision: a 1x1 head on the bottom stage and on
  decoder stages 3, 2, 1, each resized to the input (align_corners) and
  softmaxed; the main head at full size.

The output is one tensor of 40 + 5 * num_classes channels, in JAX's order:
five one-hot(8) "bicon" maps of argmaxes (the main logits', then those of
the heads of decoder stages 1, 2, 3 and the bottom: a class >= 8 one-hots
to zeros), the main softmax, then the four heads' softmaxes (bottom,
3, 2, 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from ..ops.pooling import max_pool
from ..ops.resize import resize_bilinear_nchw, resize_nearest_nchw
from .blocks import BatchNorm, Conv2d, conv

BICON = 8  # classes of each one-hot "bicon" map


def _ones_conv(c: int) -> nn.Conv2d:
    m = skip_init(Conv2d, c, c, 1, bias=False)
    with torch.no_grad():
        m.weight.fill_(1.0)
    return m


class SDA(nn.Module):
    def __init__(self, c: int, p_scale: int = 4):
        super().__init__()
        self.p_scale = p_scale
        self.pixel_conv = _ones_conv(c)
        self.chan_conv = _ones_conv(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        t = max_pool(x, self.p_scale)
        hp, wp = t.shape[-2:]
        tok = t.flatten(2).transpose(1, 2).float()  # (B, N, C)
        with torch.autocast(x.device.type, enabled=False):
            pixel = tok @ tok.transpose(1, 2) / math.sqrt(hp * wp)
            pixel_out = torch.softmax(pixel, dim=-1) @ tok
            chan = tok.transpose(1, 2) @ tok / math.sqrt(float(C) * C)
            chan_out = tok @ torch.softmax(chan, dim=-1).transpose(1, 2)

        def back(t, conv):  # (B, N, C) -> NCHW at (H, W)
            t = t.transpose(1, 2).reshape(B, C, hp, wp).to(x.dtype)
            return resize_nearest_nchw(conv(t), (H, W))

        return x + 0.5 * (back(pixel_out, self.pixel_conv)
                          + back(chan_out, self.chan_conv))


class ConvStage(nn.Module):
    def __init__(self, cin: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = conv(cin, features, 3, 1, 1, generator=g)
        self.bn1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, 1, 1, generator=g)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(x)))


def _bicon(scores: torch.Tensor) -> torch.Tensor:
    """One-hot(8) of the argmax over the channels, float32 (an argmax of 8
    or more gives zeros, as ``jax.nn.one_hot``)."""
    lab = scores.argmax(dim=1, keepdim=True)
    classes = torch.arange(BICON, device=scores.device).view(1, -1, 1, 1)
    return (lab == classes).float()


class RetiFluidNet(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 4,
                 base_channels: int = 64, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        nb = base_channels
        w = [nb, nb * 2, nb * 4, nb * 8, nb * 16]
        self.initial = conv(in_channels, nb, 3, 1, 1, generator=g)
        self.enc = nn.ModuleList(ConvStage(a, b, generator=g)
                                 for a, b in zip([nb] + w, w))
        self.enc_sda = nn.ModuleList(SDA(c) for c in w)
        # decoder stages 3, 2, 1, 0 on [up(d), skip]
        self.dec = nn.ModuleList(ConvStage(w[i + 1] + w[i], w[i],
                                           generator=g)
                                 for i in (3, 2, 1, 0))
        self.dec_sda = nn.ModuleList(SDA(w[i]) for i in (3, 2, 1, 0))
        # the heads of the bottom stage and decoder stages 3, 2, 1; main
        self.heads = nn.ModuleList(conv(w[i], num_classes, 1, generator=g)
                                   for i in (4, 3, 2, 1))
        self.main = conv(nb, num_classes, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.initial(x)
        in_hw = x.shape[-2:]

        def head(feat, conv):
            up = resize_bilinear_nchw(feat, in_hw, True)
            return torch.softmax(conv(up).float(), dim=1)

        encs, h = [], x
        for i, (stage, sda) in enumerate(zip(self.enc, self.enc_sda)):
            c = stage(h if i == 0 else max_pool(h, 2))
            h = c + sda(c)
            encs.append(h)
        d = encs[4]
        probs = [head(d, self.heads[0])]
        for k, lvl in enumerate((3, 2, 1, 0)):
            skip = encs[lvl]
            d = resize_bilinear_nchw(d, skip.shape[-2:], True)
            d = self.dec[k](torch.cat([d, skip], dim=1))
            d = d + self.dec_sda[k](d)
            if lvl:
                probs.append(head(d, self.heads[k + 1]))
        main_logits = self.main(d).float()
        main = torch.softmax(main_logits, dim=1)
        bicons = [_bicon(main_logits)] + [_bicon(p) for p in probs[::-1]]
        return torch.cat(bicons + [main] + probs, dim=1)


def build_retifluidnet(in_channels: int = 1, num_classes: int = 4, *,
                       seed: int = 0, device: torch.device | str = "cpu",
                       **kw) -> RetiFluidNet:
    """RetiFluidNet initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = RetiFluidNet(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()
