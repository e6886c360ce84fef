"""SDNet, the semi-supervised layer disentanglement system (the JAX
package's ``models/sdnet/sdnet.py``; reference ``SD_Layer_Net/sdnet.py``),
NCHW.

An ``AttU_Net`` body (1 -> 64 channels, levels ``channels``); two 11x11
``PredictorHead``s, one for the layer boundaries (n_classes - 1 maps) and
one for the extra anatomical surfaces; the ``LayerEngine``'s topology
cleanup; straight-through rounding to the hard anatomy; the modality VAE,
the FiLM reconstruction and the z re-estimation cycle. ``forward`` returns
the JAX model's dict; the stages are methods, as the composite training
step (``training/sdnet_pipeline.py``) uses them.

The encoder's dense layer is sized for ``img_size`` square B-scans (the
JAX model infers it from its input). Its noise is the ``eps`` the caller
gives, or drawn from ``generator``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..blocks import conv1x1
from .common import ResConvBlock, straight_through_round
from .layer_engine import LayerEngine
from .modality import FiLMDecoder, ModalityEncoder
from .unet import UNetBackbone


class PredictorHead(nn.Module):
    """ResConvBlock (cin -> 32, 11x11) and a 1x1 head."""

    def __init__(self, cin: int, out_channels: int, *,
                 generator: torch.Generator):
        super().__init__()
        self.block = ResConvBlock(cin, 32, 11, generator=generator)
        self.head = conv1x1(32, out_channels, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.block(x))


class SDNet(nn.Module):
    def __init__(self, img_size: int = 256, n_encoder_latent: int = 15,
                 n_classes: int = 4, n_anatomical_factors: int = 12,
                 channels: Sequence[int] = (32, 64, 128, 256, 512), *,
                 generator: torch.Generator):
        super().__init__()
        g = generator
        self.n_classes = n_classes
        self.extra_factors = n_anatomical_factors - n_classes
        n_anatomy = n_classes + max(self.extra_factors, 0)
        self.u_net = UNetBackbone(1, 64, tuple(channels), attention=True,
                                  generator=g)
        self.layer_predictor = PredictorHead(64, n_classes - 1, generator=g)
        self.surface_predictor = (
            PredictorHead(64, self.extra_factors, generator=g)
            if self.extra_factors > 0 else None)
        self.modality_encoder = ModalityEncoder(
            1 + n_anatomy, img_size, n_encoder_latent, generator=g)
        self.decoder = FiLMDecoder(n_anatomy, n_encoder_latent, generator=g)
        self.layer_engine = LayerEngine(n_classes)

    # -- stages ---------------------------------------------------------
    def get_layer_anatomical_factors(self, input_img: torch.Tensor):
        features = self.u_net(input_img)
        layers = self.layer_predictor(features)
        prob_map, positions, clean_masks, extra_losses = self.layer_engine(
            layers)
        if self.surface_predictor is not None:
            non_layers = torch.sigmoid(self.surface_predictor(features))
            anatomy = torch.cat([clean_masks, non_layers], dim=1)
        else:
            anatomy = clean_masks
        hard_anatomy = straight_through_round(anatomy)
        return prob_map, positions, clean_masks, hard_anatomy, extra_losses

    def get_modalities(self, input_img, anatomy, eps=None, generator=None):
        return self.modality_encoder(input_img, anatomy, eps, generator)

    def get_reconstructed_img(self, hard_anatomy, modalities):
        return self.decoder(hard_anatomy, modalities)

    def get_z_estimate(self, reconstructed, anatomy):
        # the JAX model draws (and drops) noise here too; z_mean needs none
        z_mean, _, _ = self.modality_encoder(
            reconstructed, anatomy, eps=reconstructed.new_zeros(()))
        return z_mean

    # -- full pass ------------------------------------------------------
    def forward(self, input_img: torch.Tensor,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None) -> dict:
        (prob_map, positions, clean_masks, hard_anatomy,
         extra_losses) = self.get_layer_anatomical_factors(input_img)
        z_mean, z_logvar, sampled_z = self.get_modalities(
            input_img, hard_anatomy, eps, generator)
        recon = self.get_reconstructed_img(hard_anatomy, sampled_z)
        z_estimate = self.get_z_estimate(recon, hard_anatomy)
        return {
            "prob_map": prob_map,
            "layer_positions": positions,
            "clean_masks": clean_masks,
            "hard_anatomy": hard_anatomy,
            "extra_losses": extra_losses,
            "z_mean": z_mean,
            "z_logvar": z_logvar,
            "sampled_z": sampled_z,
            "reconstruction": recon,
            "z_estimate": z_estimate,
        }


def build_sdnet(in_channels: int = 1, num_classes: int = 4, *, seed: int = 0,
                device: torch.device | str = "cpu", **kw) -> SDNet:
    """SDNet initialised on the CPU from ``seed``, then moved to
    ``device``; eval mode. ``in_channels`` is accepted for the registry's
    signature: the model takes one-channel B-scans."""
    del in_channels
    g = torch.Generator().manual_seed(seed)
    return SDNet(n_classes=num_classes, generator=g, **kw).to(device).eval()
