"""Masood 2024, hybrid learned and handcrafted choroid segmentation (the
JAX package's ``models/masood.py``; reference
``SOTAS/Layers_Segment/Masood_2024.py``), NCHW.

- four ``CNNBranch``es: five (3x3 conv with bias, BN, ReLU) of 64, 128,
  256, 128, 64 channels, 2x2 max-pools after the first three, a bilinear
  resize (align_corners) back to the input's size;
- the fixed Gabor bank (6 orientations x 8 frequencies) and Haar bank (3
  kernels) over the one-channel input (``ops/gabor.conv_same_torch``), and
  the 64 GLCM features of its first channel
  (``ops/glcm.glcm_feature_vector``) broadcast over the image, all three
  in float32 under any autocast;
- the concatenation (4 x 64 + 48 + 3 + 64) -> 1x1 conv -> sigmoid.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.gabor import conv_same_torch, gabor_bank, haar_bank
from ..ops.glcm import glcm_feature_vector
from ..ops.pooling import max_pool
from ..ops.resize import resize_bilinear_nchw
from .blocks import BatchNorm, conv

BRANCHES = 4
FIXED_FEATURES = 48 + 3 + 64  # Gabor, Haar, GLCM


class CNNBranch(nn.Module):
    WIDTHS = (64, 128, 256, 128, 64)

    def __init__(self, cin: int, *, generator: torch.Generator):
        super().__init__()
        ins = (cin,) + self.WIDTHS[:-1]
        self.convs = nn.ModuleList(conv(a, b, 3, 1, 1, generator=generator)
                                   for a, b in zip(ins, self.WIDTHS))
        self.bns = nn.ModuleList(BatchNorm(c) for c in self.WIDTHS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        in_hw = x.shape[-2:]
        for i, (conv_, bn) in enumerate(zip(self.convs, self.bns)):
            x = F.relu(bn(conv_(x)))
            if i < 3:
                x = max_pool(x, 2)
        return resize_bilinear_nchw(x, in_hw, True)


class Masood2024(nn.Module):
    def __init__(self, in_channels: int = 1, num_classes: int = 1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.branches = nn.ModuleList(CNNBranch(in_channels, generator=g)
                                      for _ in range(BRANCHES))
        width = BRANCHES * CNNBranch.WIDTHS[-1] + FIXED_FEATURES
        self.head = conv(width, num_classes, 1, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cnn = [branch(x) for branch in self.branches]
        B, _, H, W = x.shape
        with torch.autocast(x.device.type, enabled=False):
            xf = x.float()
            gabor = conv_same_torch(xf, gabor_bank())
            haar = conv_same_torch(xf, haar_bank())
            glcm = glcm_feature_vector(xf[:, 0])  # (B, 64)
        glcm = glcm[:, :, None, None].expand(B, glcm.shape[1], H, W)
        combined = torch.cat(cnn + [t.to(x.dtype)
                                    for t in (gabor, haar, glcm)], dim=1)
        return torch.sigmoid(self.head(combined))


def build_masood(in_channels: int = 1, num_classes: int = 1, *,
                 seed: int = 0, device: torch.device | str = "cpu",
                 **kw) -> Masood2024:
    """Masood 2024 initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = Masood2024(in_channels, num_classes, generator=g, **kw)
    return model.to(device).eval()
