"""ISLAM, the probabilistic-SDF ResUNet++ (the JAX package's
``models/islam.py``; reference ``SOTAS/Layers_Segment/ISLAM_2024.py``),
NCHW. Its blocks are its own, not the generic ones:

- ``instance_norm``: per image and channel over H, W, biased variance,
  eps 1e-5, no affine (torch ``InstanceNorm2d``'s default).
- ``SqueezeExcitation``: global average -> bias-free Linear C/8 -> ReLU ->
  bias-free Linear C -> sigmoid gate.
- ``StemBlock``: conv-BN-ReLU-conv beside a 1x1-BN shortcut, summed,
  SE-gated; ``ResNetBlock``: the pre-activation form (BN-ReLU-conv twice).
- ``ASPP``: 3x3 convs at dilations 1, 6, 12, 18 (``groups``), each with
  BatchNorm or GroupNorm (eps 1e-5), summed, then a grouped 1x1.
- ``AttentionBlock``: the gate from the encoder skip (BN-ReLU-conv, then
  a 2x2 max-pool) and the upstream map (BN-ReLU-conv), summed, BN-ReLU-
  conv, times the upstream map; ``DecoderBlock``: that gate, a nearest x2,
  the skip concatenated, a ``ResNetBlock``.
- ``CustomHead``: a ``DecoderBlock`` of 32, ``ASPP`` of 8, a 1x1 (ReLU
  where asked).
- ``ISLAM``: the stem (16) and five stride-2 stages (32 ... 512), ASPP of
  1024, three decoder blocks; then three heads (``use_multi_head``, with
  three ReLU log-variance heads more where ``gaussian_output``, returned
  as a pair) or the grouped chain 81 -> 81 -> ASPP(27, groups 3) -> 9
  (groups 3) [-> GroupNorm] -> ``num_classes``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import max_pool
from .blocks import BatchNorm, conv, linear

GN_EPS = 1e-5


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    m = x.mean(dim=(2, 3), keepdim=True)
    v = x.var(dim=(2, 3), keepdim=True, unbiased=False)
    return (x - m) / torch.sqrt(v + eps)


class SqueezeExcitation(nn.Module):
    def __init__(self, c: int, r: int = 8, *, generator: torch.Generator):
        super().__init__()
        self.fc1 = linear(c, c // r, generator, bias=False)
        self.fc2 = linear(c // r, c, generator, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * s[:, :, None, None]


class StemBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = conv(cin, features, 3, stride, 1, generator=g)
        self.bn1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, 1, 1, generator=g)
        self.short = conv(cin, features, 1, stride, generator=g)
        self.bn_short = BatchNorm(features)
        self.se = SqueezeExcitation(features, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv2(F.relu(self.bn1(self.conv1(x))))
        return self.se(h + self.bn_short(self.short(x)))


class ResNetBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.bn1 = BatchNorm(cin)
        self.conv1 = conv(cin, features, 3, stride, 1, generator=g)
        self.bn2 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, 1, 1, generator=g)
        self.short = conv(cin, features, 1, stride, generator=g)
        self.bn_short = BatchNorm(features)
        self.se = SqueezeExcitation(features, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.relu(self.bn1(x)))
        h = self.conv2(F.relu(self.bn2(h)))
        return self.se(h + self.bn_short(self.short(x)))


class ASPP(nn.Module):
    def __init__(self, cin: int, features: int, rates=(1, 6, 12, 18),
                 groups: int = 1, group_norm: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.convs = nn.ModuleList(
            conv(cin, features, 3, 1, r, dilation=r, groups=groups,
                 generator=g) for r in rates)
        self.norms = nn.ModuleList(
            nn.GroupNorm(groups, features, eps=GN_EPS) if group_norm
            else BatchNorm(features) for _ in rates)
        self.out = conv(features, features, 1, groups=groups, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for c, n in zip(self.convs, self.norms):
            y = n(c(x))
            acc = y if acc is None else acc + y
        return self.out(acc)


class AttentionBlock(nn.Module):
    def __init__(self, cg: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.bn_g = BatchNorm(cg)
        self.conv_g = conv(cg, features, 3, 1, 1, generator=g)
        self.bn_x = BatchNorm(features)
        self.conv_x = conv(features, features, 3, 1, 1, generator=g)
        self.bn_gc = BatchNorm(features)
        self.conv_gc = conv(features, features, 3, 1, 1, generator=g)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gp = max_pool(self.conv_g(F.relu(self.bn_g(g))), 2)
        xc = self.conv_x(F.relu(self.bn_x(x)))
        return self.conv_gc(F.relu(self.bn_gc(gp + xc))) * x


class DecoderBlock(nn.Module):
    """``cg`` skip channels, ``cx`` upstream channels."""

    def __init__(self, cg: int, cx: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.att = AttentionBlock(cg, cx, generator=generator)
        self.res = ResNetBlock(cx + cg, features, generator=generator)

    def forward(self, g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        d = self.att(g, x)
        N, C, H, W = d.shape  # nearest x2; its backward sums, in order
        d = d[:, :, :, None, :, None].expand(N, C, H, 2, W, 2).reshape(
            N, C, 2 * H, 2 * W)
        return self.res(torch.cat([d, g], dim=1))


class CustomHead(nn.Module):
    def __init__(self, cg: int, cx: int, num_class: int = 1,
                 activation: bool = False, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.activation = activation
        self.dec = DecoderBlock(cg, cx, 32, generator=g)
        self.aspp = ASPP(32, 8, generator=g)
        self.out = conv(8, num_class, 1, generator=g)

    def forward(self, c1: torch.Tensor, d5: torch.Tensor) -> torch.Tensor:
        out = self.out(self.aspp(self.dec(c1, d5)))
        return F.relu(out) if self.activation else out


class ISLAM(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 3,
                 gaussian_output: bool = False, out_act: bool = False,
                 group_norm: bool = False, use_multi_head: bool = False,
                 use_input_instance_norm: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.gaussian_output = gaussian_output
        self.use_multi_head = use_multi_head
        self.use_input_instance_norm = use_input_instance_norm
        self.stem = StemBlock(in_channels, 16, generator=g)
        widths = (16, 32, 64, 128, 256, 512)
        self.stages = nn.ModuleList(
            ResNetBlock(widths[i], widths[i + 1], 2, generator=g)
            for i in range(5))
        self.aspp = ASPP(512, 1024, generator=g)
        # (skip, upstream, out): d2 from (c5, b1), d3 (c4, d2), d4 (c3, d3)
        self.decoders = nn.ModuleList(
            DecoderBlock(cg, cx, f, generator=g)
            for cg, cx, f in ((256, 1024, 512), (128, 512, 256),
                              (64, 256, 128)))
        if use_multi_head:
            self.dec5 = DecoderBlock(32, 128, 64, generator=g)
            self.heads = nn.ModuleList(
                CustomHead(16, 64, 1, out_act, generator=g)
                for _ in range(3))
            if gaussian_output:
                self.var_heads = nn.ModuleList(
                    CustomHead(16, 64, 1, True, generator=g)
                    for _ in range(3))
        else:
            self.dec5 = DecoderBlock(32, 128, 81, generator=g)
            self.dec6 = DecoderBlock(16, 81, 81, generator=g)
            self.aspp_out = ASPP(81, 27, groups=3, group_norm=group_norm,
                                 generator=g)
            self.conv9 = conv(27, 9, 1, groups=3, generator=g)
            self.gn = (nn.GroupNorm(3, 9, eps=GN_EPS) if group_norm
                       else None)
            self.head = conv(9, num_classes, 1, generator=g)

    def forward(self, x: torch.Tensor):
        if self.use_input_instance_norm:
            x = instance_norm(x)
        cs = [self.stem(x)]
        for stage in self.stages:
            cs.append(stage(cs[-1]))
        d = self.aspp(cs[5])
        for lvl, dec in zip((4, 3, 2), self.decoders):
            d = dec(cs[lvl], d)
        if self.use_multi_head:
            d5 = self.dec5(cs[1], d)
            out = torch.cat([h(cs[0], d5) for h in self.heads], dim=1)
            if self.gaussian_output:
                return out, torch.cat([h(cs[0], d5) for h in self.var_heads],
                                      dim=1)
            return out
        d = self.dec6(cs[0], self.dec5(cs[1], d))
        out = self.conv9(self.aspp_out(d))
        if self.gn is not None:
            out = self.gn(out)
        return self.head(out)


def build_islam(in_channels: int = 1, num_classes: int = 3, *,
                seed: int = 0, device: torch.device | str = "cpu",
                **kw) -> ISLAM:
    """ISLAM initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = ISLAM(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()
