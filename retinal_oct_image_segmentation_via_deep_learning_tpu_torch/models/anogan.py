"""f-AnoGAN (Schlegl et al. 2019), the JAX package's ``models/anogan.py``
(reference ``Lesions_Segment/AnoGAN_2019.py``), NCHW.

Encoder: 4x4 convs without bias, strides 2, 2, 2 and a valid stride 1, 1
-> 32 -> 64 -> 64 -> 64, LeakyReLU(0.2), BN from the second. Decoder: the
mirror in transposed convs (k4; s1 p0, then s2 p1) with BN + ReLU and a
sigmoid. Generator = encoder + decoder -> (features, reconstruction);
Discriminator = an encoder + a 1x1 conv head to 32 then 1 channel ->
(features, logits). ``AnoGAN(x, mode="train")`` returns the adversarial
tensors; any other mode the reconstruction. The discriminator reads the
images and the reconstructions, so ``out_channels`` = ``in_channels``.
Training: ``training/adversarial.AnoGANTrainer``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import batch_norm, conv, conv_transpose


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 1, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.convs = nn.ModuleList([
            conv(in_channels, 32, 4, 2, 1, bias=False, generator=g),
            conv(32, 64, 4, 2, 1, bias=False, generator=g),
            conv(64, 64, 4, 2, 1, bias=False, generator=g),
            conv(64, 64, 4, 1, 0, bias=False, generator=g)])
        self.bns = nn.ModuleList([batch_norm(64), batch_norm(64)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.convs[0](x), 0.2)
        for c, bn in zip(self.convs[1:3], self.bns):
            x = F.leaky_relu(bn(c(x)), 0.2)
        return self.convs[3](x)


class Decoder(nn.Module):
    def __init__(self, out_channels: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.ups = nn.ModuleList([
            conv_transpose(64, 64, 4, 1, 0, bias=False, generator=g),
            conv_transpose(64, 64, 4, 2, 1, bias=False, generator=g),
            conv_transpose(64, 32, 4, 2, 1, bias=False, generator=g),
            conv_transpose(32, out_channels, 4, 2, 1, bias=False,
                           generator=g)])
        self.bns = nn.ModuleList([batch_norm(64), batch_norm(64),
                                  batch_norm(32)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for up, bn in zip(self.ups, self.bns):
            x = F.relu(bn(up(x)))
        return torch.sigmoid(self.ups[3](x))


class Generator(nn.Module):
    def __init__(self, in_channels: int = 1, out_channels: int = 1, *,
                 generator: torch.Generator):
        super().__init__()
        self.encoder = Encoder(in_channels, generator=generator)
        self.decoder = Decoder(out_channels, generator=generator)

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        return features, self.decoder(features)


class Discriminator(nn.Module):
    def __init__(self, in_channels: int = 1, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.encoder = Encoder(in_channels, generator=g)
        self.fc1 = conv(64, 32, 1, generator=g)
        self.fc2 = conv(32, 1, 1, generator=g)

    def forward(self, x: torch.Tensor):
        features = self.encoder(x)
        return features, self.fc2(self.fc1(features))


class AnoGAN(nn.Module):
    """Composite G + D (reference ``AnoGAN``, :92-124)."""

    def __init__(self, in_channels: int = 1, out_channels: int = 1, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator()
        self.G = Generator(in_channels, out_channels, generator=g)
        self.D = Discriminator(in_channels, generator=g)

    def forward(self, x: torch.Tensor, mode: str = "train"):
        if mode != "train":
            return self.G(x)[1]
        g_features, fake = self.G(x)
        d_feat_real, d_pred_real = self.D(x)
        d_feat_fake, d_pred_fake = self.D(fake)
        return {"g_features": g_features, "fake_images": fake,
                "d_features_real": d_feat_real, "d_pred_real": d_pred_real,
                "d_features_fake": d_feat_fake, "d_pred_fake": d_pred_fake}

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """Reference ``AnoGAN.encode`` (:118-120)."""
        return self.G.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Reference ``AnoGAN.decode`` (:122-124)."""
        return self.G.decoder(z)


def build_anogan(in_channels: int = 1, num_classes: int = 1, *,
                 seed: int = 0, device: torch.device | str = "cpu"
                 ) -> AnoGAN:
    """AnoGAN initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode. ``num_classes`` is the generator's output
    channels (the JAX builder's name)."""
    g = torch.Generator().manual_seed(seed)
    model = AnoGAN(in_channels, num_classes, generator=g)
    return model.to(device).eval()
