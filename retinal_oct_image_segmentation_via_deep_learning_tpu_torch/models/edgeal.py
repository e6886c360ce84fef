"""EdgeAL's FFC-ResNet generator (the JAX package's ``models/edgeal.py``;
reference ``Lesions_Segment/EdgeAL_2021.py:411-494``), NCHW.

Reflect pad 3 + 7x7 ``FFC_BN_ACT`` stem (local input only) ->
``n_downsampling`` stride-2 3x3 ``FFC_BN_ACT`` (their g2g average-pools;
the last switches the global share to ``ratio_gin``) -> ``n_blocks``
``FFCResnetBlock`` -> the stream concatenated -> ``n_downsampling``
transposed convs (k3, s2, p1, output padding 1) with BN + ReLU -> reflect
pad 3 + 7x7 conv head -> tanh. ReLU throughout; channel shares 0.75.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import batch_norm, conv, conv_transpose
from .ffc import FFC_BN_ACT, FFCResnetBlock, concat_stream


class EdgeAL(nn.Module):
    def __init__(self, in_channels: int = 3, num_classes: int = 3,
                 ngf: int = 64, n_downsampling: int = 3, n_blocks: int = 9,
                 ratio_gin: float = 0.75, ratio_gout: float = 0.75,
                 max_features: int = 1024, add_out_act: bool = True, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        mf = max_features
        self.add_out_act = add_out_act
        self.stem = FFC_BN_ACT((in_channels, 0), ngf, 7, ratio_gout,
                               act="relu", generator=g)
        split, downs = self.stem.out_channels, []
        for i in range(n_downsampling):
            gout = ratio_gin if i == n_downsampling - 1 else ratio_gout
            downs.append(FFC_BN_ACT(split, min(mf, ngf * 2 ** (i + 1)), 3,
                                    gout, stride=2, padding=1, act="relu",
                                    generator=g))
            split = downs[-1].out_channels
        self.downs = nn.ModuleList(downs)
        feats = min(mf, ngf * 2 ** n_downsampling)
        self.blocks = nn.ModuleList(
            FFCResnetBlock(feats, ratio_gin, ratio_gin, act="relu",
                           generator=g) for _ in range(n_blocks))
        ups, bns, cin = [], [], feats
        for i in range(n_downsampling):
            cout = min(mf, int(ngf * 2 ** (n_downsampling - i) / 2))
            ups.append(conv_transpose(cin, cout, 3, 2, 1, 1, generator=g))
            bns.append(batch_norm(cout))
            cin = cout
        self.ups = nn.ModuleList(ups)
        self.up_bns = nn.ModuleList(bns)
        self.head = conv(cin, num_classes, 7, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stream = self.stem((F.pad(x, (3, 3, 3, 3), mode="reflect"), None))
        for layer in self.downs:
            stream = layer(stream)
        for block in self.blocks:
            stream = block(stream)
        h = concat_stream(stream)
        for up, bn in zip(self.ups, self.up_bns):
            h = F.relu(bn(up(h)))
        h = self.head(F.pad(h, (3, 3, 3, 3), mode="reflect"))
        return torch.tanh(h) if self.add_out_act else h


def build_edgeal(in_channels: int = 3, num_classes: int = 3, *,
                 seed: int = 0, device: torch.device | str = "cpu",
                 **kw) -> EdgeAL:
    """EdgeAL initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = EdgeAL(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()
