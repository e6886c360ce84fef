"""LightReSeg, a light encoder with a ViT bottleneck (the JAX package's
``models/lightreseg.py``; reference
``SOTAS/Layers_Segment/LightReSeg_2024.py``), NCHW.

- ``ContractingBlock``: (3x3 conv -> ReLU -> BN) x 2, ReLU before BN as
  in the reference.
- ``SeparableDown``: depthwise 3x3 stride 2 -> 1x1 -> BN -> ReLU ->
  depthwise 1x1 -> 1x1 -> BN -> ReLU, bias-free, He-normal (fan out).
- ``ViTBlockStack``: 3 pre-norm layers (LayerNorm eps 1e-6, as flax's) of
  8-head x 64 attention (softmax in float32) and an MLP of 768 with the
  exact GELU; Dense weights truncated N(0, 0.02).
- ``ChannelAttentionModule``: the (C, C) affinity of the map with itself
  over H * W in float32 under any autocast, max-subtracted, softmax, and
  ``gamma * out + x`` with ``gamma`` initialised to zero.
- ``AttentionModule``: depthwise 5x5, then the 1x7/7x1, 1x11/11x1 and
  1x3/3x1 strips, a channel attention on each of the four maps, a 1x1 of
  their concatenation as the gate on the input.
- ``ExpansiveBlock``: transposed conv k3 s2 p1 (output padding 1) halving
  the channels, plus ``0.8 * attn(e) + e`` of the skip.
- ``LightReSeg``: four contracting + separable-down stages (16 ... 128),
  the 1/16-scale map as tokens (a Dense of 128) behind a ``cls_token``
  with ``pos_embedding[:, :n + 1]`` added, the ViT stack, the tokens back
  on the map plus the map, a contracting block of 256, four expansive
  blocks, a 1x1 head, ReLU, BN.

The token grid is the input's (H / 16 x W / 16), as in JAX; more than
``num_positions - 1`` tokens raise.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.nn.utils import skip_init

from .blocks import BatchNorm, Conv2d, conv, conv_transpose, redraw

LN_EPS = 1e-6


def _dense(cin: int, cout: int, bias: bool = True, *,
           generator: torch.Generator) -> nn.Linear:
    """A Linear with weights truncated N(0, 0.02) (at +-2 std) and zero
    biases."""
    return redraw(skip_init(nn.Linear, cin, cout, bias=bias), 0.02,
                  generator, truncated=True)


def _sep_conv(cin: int, cout: int, k: int, stride: int = 1,
              padding: int = 0, groups: int = 1, *,
              generator: torch.Generator) -> nn.Conv2d:
    """A bias-free conv with weights N(0, 2 / fan_out)."""
    return redraw(skip_init(Conv2d, cin, cout, k, stride=stride,
                            padding=padding, groups=groups, bias=False),
                  math.sqrt(2.0 / (cout * k * k)), generator)


class ContractingBlock(nn.Module):
    def __init__(self, cin: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.conv1 = conv(cin, features, 3, 1, 1, generator=g)
        self.bn1 = BatchNorm(features)
        self.conv2 = conv(features, features, 3, 1, 1, generator=g)
        self.bn2 = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1(F.relu(self.conv1(x)))
        return self.bn2(F.relu(self.conv2(x)))


class SeparableDown(nn.Module):
    def __init__(self, cin: int, features: int, *,
                 generator: torch.Generator):
        super().__init__()
        g, f = generator, features
        self.dw1 = _sep_conv(cin, cin, 3, 2, 1, groups=cin, generator=g)
        self.pw1 = _sep_conv(cin, f, 1, generator=g)
        self.bn1 = BatchNorm(f)
        self.dw2 = _sep_conv(f, f, 1, groups=f, generator=g)
        self.pw2 = _sep_conv(f, f, 1, generator=g)
        self.bn2 = BatchNorm(f)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.pw1(self.dw1(x))))
        return F.relu(self.bn2(self.pw2(self.dw2(x))))


class ViTAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.qkv = _dense(dim, 3 * inner, bias=False, generator=generator)
        self.out = _dense(inner, dim, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        q, k, v = (t.reshape(B, N, self.heads, self.dim_head).transpose(1, 2)
                   for t in self.qkv(x).chunk(3, dim=-1))
        dots = q @ k.transpose(-1, -2) * self.dim_head ** -0.5
        attn = torch.softmax(dots.float(), dim=-1).to(q.dtype)
        out = (attn @ v).transpose(1, 2).reshape(B, N, -1)
        return self.out(out)


class ViTLayer(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = ViTAttention(dim, generator=g)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = _dense(dim, mlp_dim, generator=g)
        self.fc2 = _dense(mlp_dim, dim, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attn(self.norm1(x)) + x
        return self.fc2(F.gelu(self.fc1(self.norm2(x)))) + x


class ChannelAttentionModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        N, C, H, W = x.shape
        t = x.reshape(N, C, H * W).float()
        with torch.autocast(x.device.type, enabled=False):
            energy = t @ t.transpose(1, 2)  # (N, C, C)
            energy = energy.amax(dim=-1, keepdim=True) - energy
            out = torch.softmax(energy, dim=-1) @ t
        return (self.gamma.to(x.dtype) * out.reshape(N, C, H, W).to(x.dtype)
                + x)


class AttentionModule(nn.Module):
    # the (kernel, padding) of the strip convs after the 5x5, in pairs
    STRIPS = (((1, 7), (0, 3)), ((7, 1), (3, 0)), ((1, 11), (0, 5)),
              ((11, 1), (5, 0)), ((1, 3), (0, 1)), ((3, 1), (1, 0)))

    def __init__(self, c: int, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.dw = nn.ModuleList(
            [conv(c, c, 5, 1, 2, groups=c, generator=g)]
            + [conv(c, c, k, 1, p, groups=c, generator=g)
               for k, p in self.STRIPS])
        self.cam = nn.ModuleList(ChannelAttentionModule() for _ in range(4))
        self.gate = conv(4 * c, c, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn = self.dw[0](x)
        maps = [attn]
        for i in (1, 3, 5):
            maps.append(self.dw[i + 1](self.dw[i](attn)))
        cat = torch.cat([cam(m) for cam, m in zip(self.cam, maps)], dim=1)
        return self.gate(cat) * x


class ExpansiveBlock(nn.Module):
    def __init__(self, c: int, *, generator: torch.Generator):
        super().__init__()
        self.up = conv_transpose(c, c // 2, 3, 2, 1, 1, generator=generator)
        self.att = AttentionModule(c // 2, generator=generator)

    def forward(self, e: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        return 0.8 * self.att(e) + e + self.up(d)


class LightReSeg(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 7,
                 num_positions: int = 1445, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        widths = (16, 32, 64, 128)
        self.contract = nn.ModuleList()
        self.down = nn.ModuleList()
        cin = in_channels
        for f in widths:
            self.contract.append(ContractingBlock(cin, f, generator=g))
            self.down.append(SeparableDown(f, f, generator=g))
            cin = f
        self.embed = _dense(128, 128, generator=g)
        self.cls_token = nn.Parameter(
            torch.randn((1, 1, 128), generator=g))
        self.pos_embedding = nn.Parameter(
            torch.randn((1, num_positions, 128), generator=g))
        self.vit = nn.ModuleList(ViTLayer(128, 768, generator=g)
                                 for _ in range(3))
        self.bottleneck = ContractingBlock(128, 256, generator=g)
        self.expand = nn.ModuleList(ExpansiveBlock(c, generator=g)
                                    for c in (256, 128, 64, 32))
        self.head = conv(16, num_classes, 1, generator=g)
        self.head_bn = BatchNorm(num_classes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips, pooled = [], x
        for block, down in zip(self.contract, self.down):
            skips.append(block(pooled))
            pooled = down(skips[-1])
        B, C, h, w = pooled.shape
        n = h * w
        if n + 1 > self.pos_embedding.shape[1]:
            raise ValueError(
                f"LightReSeg: {h}x{w} = {n} tokens, more than the "
                f"{self.pos_embedding.shape[1] - 1} positions")
        tokens = self.embed(pooled.flatten(2).transpose(1, 2))
        tokens = torch.cat([self.cls_token.to(tokens.dtype).expand(B, 1, -1),
                            tokens], dim=1)
        tokens = tokens + self.pos_embedding[:, :n + 1].to(tokens.dtype)
        for layer in self.vit:
            tokens = layer(tokens)
        pooled = tokens[:, 1:].transpose(1, 2).reshape(B, C, h, w) + pooled
        d = self.bottleneck(pooled)
        for lvl, block in zip((3, 2, 1, 0), self.expand):
            d = block(skips[lvl], d)
        return self.head_bn(F.relu(self.head(d)))


def build_lightreseg(in_channels: int = 1, num_classes: int = 7, *,
                     seed: int = 0, device: torch.device | str = "cpu",
                     **kw) -> LightReSeg:
    """LightReSeg initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = LightReSeg(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()
