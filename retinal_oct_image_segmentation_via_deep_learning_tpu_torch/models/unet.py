"""Vanilla 4-level U-Net (the JAX package's ``models/unet.UNet``).

NCHW ``nn.Module`` with the torch reference's parameter names
(``encoder1.enc1conv1``, ..., ``bottleneck``, ``upconvN``, ``decoderN``,
``conv``), so a state dict maps onto the JAX variables through
``utils/torch_compat.import_torch_state(..., transposed=lambda n: "upconv"
in n)`` and back through ``utils/convert.unet_state_dict_from_jax``.
Returns logits (no softmax).
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import batch_norm, conv1x1, conv3x3, conv_transpose2x2

# Module prefix of each U-Net block in forward order (blk0..blk8 of the int8
# graph) and name of each transposed conv (ct0..ct3).
BLOCK_PREFIXES = ("encoder1.enc1", "encoder2.enc2", "encoder3.enc3",
                  "encoder4.enc4", "bottleneck.bottleneck", "decoder4.dec4",
                  "decoder3.dec3", "decoder2.dec2", "decoder1.dec1")
UPCONV_NAMES = ("upconv4", "upconv3", "upconv2", "upconv1")


def unet_block(cin: int, features: int, name: str,
               generator: torch.Generator) -> nn.Sequential:
    """conv3x3(no bias)-BN-ReLU twice (``UNetBlock``)."""
    return nn.Sequential(OrderedDict([
        (f"{name}conv1", conv3x3(cin, features, generator)),
        (f"{name}norm1", batch_norm(features)),
        (f"{name}relu1", nn.ReLU(inplace=True)),
        (f"{name}conv2", conv3x3(features, features, generator)),
        (f"{name}norm2", batch_norm(features)),
        (f"{name}relu2", nn.ReLU(inplace=True)),
    ]))


class UNet(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1,
                 init_features: int = 32, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        f = init_features
        self.encoder1 = unet_block(in_channels, f, "enc1", g)
        self.encoder2 = unet_block(f, 2 * f, "enc2", g)
        self.encoder3 = unet_block(2 * f, 4 * f, "enc3", g)
        self.encoder4 = unet_block(4 * f, 8 * f, "enc4", g)
        self.bottleneck = unet_block(8 * f, 16 * f, "bottleneck", g)
        self.upconv4 = conv_transpose2x2(16 * f, 8 * f, g)
        self.decoder4 = unet_block(16 * f, 8 * f, "dec4", g)
        self.upconv3 = conv_transpose2x2(8 * f, 4 * f, g)
        self.decoder3 = unet_block(8 * f, 4 * f, "dec3", g)
        self.upconv2 = conv_transpose2x2(4 * f, 2 * f, g)
        self.decoder2 = unet_block(4 * f, 2 * f, "dec2", g)
        self.upconv1 = conv_transpose2x2(2 * f, f, g)
        self.decoder1 = unet_block(2 * f, f, "dec1", g)
        self.conv = conv1x1(f, out_channels, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        enc1 = self.encoder1(x)
        enc2 = self.encoder2(F.max_pool2d(enc1, 2))
        enc3 = self.encoder3(F.max_pool2d(enc2, 2))
        enc4 = self.encoder4(F.max_pool2d(enc3, 2))
        d = self.bottleneck(F.max_pool2d(enc4, 2))
        for up, dec, skip in ((self.upconv4, self.decoder4, enc4),
                              (self.upconv3, self.decoder3, enc3),
                              (self.upconv2, self.decoder2, enc2),
                              (self.upconv1, self.decoder1, enc1)):
            d = dec(torch.cat([up(d), skip], dim=1))
        return self.conv(d)


def build_unet(in_channels: int = 1, num_classes: int = 9, *,
               init_features: int = 32, seed: int = 0,
               device: torch.device | str = "cpu") -> UNet:
    """U-Net initialised on the CPU from ``seed`` (so the weights do not
    depend on the device), then moved to ``device``; eval mode."""
    g = torch.Generator().manual_seed(seed)
    model = UNet(in_channels, num_classes, init_features, generator=g)
    return model.to(device).eval()
