"""Vanilla 4-level U-Net and the Y-Net dual-encoder U-Net (the JAX
package's ``models/unet.UNet`` and ``YNet``).

NCHW ``nn.Module``s. The U-Net has the torch reference's parameter names
(``encoder1.enc1conv1``, ..., ``bottleneck``, ``upconvN``, ``decoderN``,
``conv``), so a state dict maps onto the JAX variables through
``utils/torch_compat.import_torch_state(..., transposed=lambda n: "upconv"
in n)`` and back through ``utils/convert.unet_state_dict_from_jax``. Y-Net
keeps those names and adds its second encoder (``encoderN_f``);
``utils/convert.ynet_layer_map`` carries its weights. Both return logits
unless ``apply_softmax``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.pooling import max_pool
from .blocks import batch_norm, conv1x1, conv3x3, conv_transpose2x2
from .ffc import FFC_BN_ACT, concat_stream

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


def _cat_merge_interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's ``cat_merge`` bottleneck fusion (``YNet_2022.py:
    774-787``): both tensors flattened in NCHW order, interleaved element
    by element and read back as (N, Ca + Cb, H, W); not a channel concat."""
    N, Ca, H, W = a.shape
    inter = torch.stack([a.reshape(-1), b.reshape(-1)], dim=1)
    return inter.reshape(N, Ca + b.shape[1], H, W)


def _pool_stream(s):
    return tuple(max_pool(t, 2) if t is not None else None for t in s)


class YNet(nn.Module):
    """Y-Net (reference ``YNet_general``, ``YNet_2022.py:605``): the U-Net's
    spatial encoder (enc4 is 4f, not 8f) beside a second encoder, the
    spectral one of 1x1 ``FFC_BN_ACT`` stages over a (local, global) stream
    (``ffc``) or a copy of the spatial one; the two bottom maps fused by
    ``cat_merge`` (or a channel concat) into the 8f-wide bottleneck input;
    the decoder concatenates ``[up, skip]``, with ``skip_ffc``
    ``[up, skip, skip_f]``."""

    def __init__(self, in_channels: int = 1, num_classes: int = 1,
                 init_features: int = 32, ratio_in: float = 0.5,
                 ffc: bool = True, skip_ffc: bool = False,
                 cat_merge: bool = True, apply_softmax: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        f, r = init_features, ratio_in
        self.ffc, self.skip_ffc = ffc, skip_ffc
        self.cat_merge, self.apply_softmax = cat_merge, apply_softmax
        widths = (f, 2 * f, 4 * f, 4 * f)
        cin = in_channels
        for i, w in enumerate(widths, 1):
            setattr(self, f"encoder{i}", unet_block(cin, w, f"enc{i}", g))
            cin = w
        if ffc:
            split = (in_channels, 0)
            for i, w in enumerate(widths, 1):
                stage = FFC_BN_ACT(split, w, 1, r, generator=g)
                setattr(self, f"encoder{i}_f", stage)
                split = stage.out_channels
        else:
            cin = in_channels
            for i, w in enumerate(widths, 1):
                setattr(self, f"encoder{i}_f",
                        unet_block(cin, w, f"enc{i}_f", g))
                cin = w
        self.bottleneck = unet_block(8 * f, 16 * f, "bottleneck", g)
        skip = 2 if skip_ffc else 1
        self.upconv4 = conv_transpose2x2(16 * f, 8 * f, g)
        self.decoder4 = unet_block(8 * f + skip * 4 * f, 8 * f, "dec4", g)
        self.upconv3 = conv_transpose2x2(8 * f, 4 * f, g)
        self.decoder3 = unet_block(4 * f + skip * 4 * f, 4 * f, "dec3", g)
        self.upconv2 = conv_transpose2x2(4 * f, 2 * f, g)
        self.decoder2 = unet_block(2 * f + skip * 2 * f, 2 * f, "dec2", g)
        self.upconv1 = conv_transpose2x2(2 * f, f, g)
        self.decoder1 = unet_block(f + skip * f, f, "dec1", g)
        self.conv = conv1x1(f, num_classes, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        skips = [self.encoder1(x)]
        for i in (2, 3, 4):
            skips.append(getattr(self, f"encoder{i}")(max_pool(skips[-1], 2)))
        enc4_2 = max_pool(skips[-1], 2)
        if self.ffc:
            streams = [self.encoder1_f((x, None))]
            for i in (2, 3, 4):
                streams.append(getattr(self, f"encoder{i}_f")(
                    _pool_stream(streams[-1])))
            enc4_f2 = concat_stream(_pool_stream(streams[-1]))
            skips_f = [concat_stream(s) for s in streams]
        else:
            skips_f = [self.encoder1_f(x)]
            for i in (2, 3, 4):
                skips_f.append(getattr(self, f"encoder{i}_f")(
                    max_pool(skips_f[-1], 2)))
            enc4_f2 = max_pool(skips_f[-1], 2)
        if self.cat_merge:
            d = _cat_merge_interleave(enc4_2, enc4_f2)
        else:
            d = torch.cat([enc4_2, enc4_f2], dim=1)
        d = self.bottleneck(d)
        for lvl, up, dec in ((3, self.upconv4, self.decoder4),
                             (2, self.upconv3, self.decoder3),
                             (1, self.upconv2, self.decoder2),
                             (0, self.upconv1, self.decoder1)):
            parts = [up(d), skips[lvl]]
            if self.skip_ffc:
                parts.append(skips_f[lvl])
            d = dec(torch.cat(parts, dim=1))
        logits = self.conv(d)
        return torch.softmax(logits, dim=1) if self.apply_softmax else logits


def _build_ynet(ffc: bool, in_channels: int, num_classes: int, seed: int,
                device, **kw) -> YNet:
    g = torch.Generator().manual_seed(seed)
    model = YNet(in_channels, num_classes, ffc=ffc, generator=g, **kw)
    return model.to(device).eval()


def build_ynet(in_channels: int = 1, num_classes: int = 9, *, seed: int = 0,
               device: torch.device | str = "cpu", **kw) -> YNet:
    """Y-Net with a copy of the spatial encoder (``y_net_gen``),
    initialised on the CPU from ``seed``, then moved to ``device``; eval
    mode."""
    return _build_ynet(False, in_channels, num_classes, seed, device, **kw)


def build_ynet_ffc(in_channels: int = 1, num_classes: int = 9,
                   ratio: float = 0.5, *, seed: int = 0,
                   device: torch.device | str = "cpu", **kw) -> YNet:
    """Y-Net with the spectral FFC encoder (``y_net_gen_ffc``), global
    share ``ratio``; as ``build_ynet``."""
    return _build_ynet(True, in_channels, num_classes, seed, device,
                       ratio_in=ratio, **kw)
