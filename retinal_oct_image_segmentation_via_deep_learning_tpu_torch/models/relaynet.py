"""ReLayNet (Roy et al. 2017), the JAX package's ``models/relaynet.ReLayNet``.

Three encoder blocks, a bottleneck and three decoder blocks; each block is
one 7x3 conv with bias (padding (3, 1)), BatchNorm and a PReLU with one
shared slope. Encoders max-pool 2x2 with window indices; each decoder
unpools to them and convolves ``cat([skip, unpooled])`` (the skip first).
A 1x1 conv head returns logits (no softmax). NCHW, like the port's U-Net.

Parameters are registered block by block in call order (conv, norm, prelu;
then the head), the order in which ``utils/torch_compat.import_torch_state``
of the JAX package zips a state dict onto the JAX variables;
``utils/convert.relaynet_state_dict_from_jax`` goes the other way.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
from torch import nn

from ..ops.pooling import max_pool_argmax, max_unpool
from .blocks import batch_norm, conv1x1, conv_same

# Module name of each block in call order: b0..b6 of the int8 graph.
BLOCK_NAMES = ("encode1", "encode2", "encode3", "bottleneck", "decode1",
               "decode2", "decode3")


def relaynet_block(cin: int, features: int, kernel: tuple[int, int],
                   generator: torch.Generator) -> nn.Sequential:
    """conv (bias) -> BN -> PReLU (``ReLayNetBlock``)."""
    return nn.Sequential(OrderedDict([
        ("conv", conv_same(cin, features, kernel, generator)),
        ("norm", batch_norm(features)),
        ("prelu", nn.PReLU(1)),
    ]))


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


class ReLayNet(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 10,
                 num_filters: int = 64, kernel_h: int = 7, kernel_w: int = 3,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        f, k = num_filters, (kernel_h, kernel_w)
        cins = (in_channels, f, f, f, 2 * f, 2 * f, 2 * f)
        for name, cin in zip(BLOCK_NAMES, cins):
            self.add_module(name, relaynet_block(cin, f, k, g))
        self.classifier = conv1x1(f, num_classes, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        blocks = [getattr(self, n) for n in BLOCK_NAMES]
        skips, idxs = [], []
        for block in blocks[:3]:
            s = block(x)
            pooled, idx = max_pool_argmax(_nhwc(s))
            skips.append(s)
            idxs.append(idx)
            x = _nchw(pooled)
        x = blocks[3](x)
        for block, s, idx in zip(blocks[4:], reversed(skips), reversed(idxs)):
            up = _nchw(max_unpool(_nhwc(x), idx))
            x = block(torch.cat([s, up], dim=1))
        return self.classifier(x)


def build_relaynet(in_channels: int = 1, num_classes: int = 10, *,
                   num_filters: int = 64, seed: int = 0,
                   device: torch.device | str = "cpu") -> ReLayNet:
    """ReLayNet initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = ReLayNet(in_channels, num_classes, num_filters, generator=g)
    return model.to(device).eval()
