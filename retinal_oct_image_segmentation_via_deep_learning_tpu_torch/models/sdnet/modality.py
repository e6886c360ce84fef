"""Modality VAE encoder and FiLM decoder (the JAX package's
``models/sdnet/modality.py``), NCHW.

Encoder: cat(image, anatomy factors) -> four stride-2
conv-BN-LeakyReLU(0.2) stages of 16 channels -> dense 32 (BN over the
features, LeakyReLU) -> z_mean and z_logvar heads, and the sample
z_mean + eps * exp(z_logvar / 2). The dense layer reads the features in the
JAX package's (h, w, c) order, so its weight is the Flax kernel transposed.

Decoder: four FiLM layers that condition the anatomy maps on the modality
latent (conv-lrelu, conv-lrelu, dense-lrelu-dense-lrelu -> (gamma, beta),
``lrelu(conv2 * gamma + beta)`` added to the first conv's output), then a
3x3 conv and tanh.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import batch_norm, conv3x3_stride2, conv_same, linear


def _lrelu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class ModalityEncoder(nn.Module):
    def __init__(self, in_channels: int, img_size: int, n_latent: int = 15,
                 n_channels: int = 16, *, generator: torch.Generator):
        super().__init__()
        g = generator
        self.convs = nn.ModuleList(
            conv3x3_stride2(cin, n_channels, g)
            for cin in [in_channels] + [n_channels] * 3)
        self.bns = nn.ModuleList(batch_norm(n_channels) for _ in range(4))
        side = img_size
        for _ in range(4):
            side = (side + 1) // 2
        self.fc = linear(n_channels * side * side, 32, g)
        self.fc_bn = batch_norm(32)
        self.z_mean = linear(32, n_latent, g)
        self.z_logvar = linear(32, n_latent, g)

    def forward(self, image: torch.Tensor, anatomy: torch.Tensor,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None):
        """-> (z_mean, z_logvar, sampled z). The noise is ``eps`` when
        given, else drawn from ``generator`` (N(0, 1))."""
        h = torch.cat([image, anatomy], dim=1)
        for conv, bn in zip(self.convs, self.bns):
            h = _lrelu(bn(conv(h)))
        h = h.permute(0, 2, 3, 1).flatten(1)  # (h, w, c) order
        h = _lrelu(self.fc_bn(self.fc(h)))
        z_mean, z_logvar = self.z_mean(h), self.z_logvar(h)
        if eps is None:
            dev = generator.device if generator is not None else h.device
            eps = torch.randn(z_mean.shape, generator=generator, device=dev)
        sampled = z_mean + eps.to(z_mean.device) * torch.exp(0.5 * z_logvar)
        return z_mean, z_logvar, sampled


class FiLMLayer(nn.Module):
    def __init__(self, cin: int, n_latent: int, n_filters: int = 16, *,
                 generator: torch.Generator):
        super().__init__()
        g, f = generator, n_filters
        self.conv1 = conv_same(cin, f, (3, 3), g)
        self.conv2 = conv_same(f, f, (3, 3), g)
        self.fc1 = linear(n_latent, 2 * f, g)
        self.fc2 = linear(2 * f, 2 * f, g)

    def forward(self, x: torch.Tensor, modalities: torch.Tensor):
        conv1 = _lrelu(self.conv1(x))
        conv2 = _lrelu(self.conv2(conv1))
        d = _lrelu(self.fc2(_lrelu(self.fc1(modalities))))
        f = conv2.shape[1]
        gamma, beta = d[:, :f, None, None], d[:, f:, None, None]
        return conv1 + _lrelu(conv2 * gamma + beta)


class FiLMDecoder(nn.Module):
    def __init__(self, n_anatomy: int, n_latent: int, n_filters: int = 16, *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.film = nn.ModuleList(
            FiLMLayer(cin, n_latent, n_filters, generator=g)
            for cin in [n_anatomy] + [n_filters] * 3)
        self.out = conv_same(n_filters, 1, (3, 3), g)

    def forward(self, anatomy: torch.Tensor,
                modalities: torch.Tensor) -> torch.Tensor:
        h = anatomy
        for layer in self.film:
            h = layer(h, modalities)
        return torch.tanh(self.out(h))
