"""Two-optimizer adversarial training of f-AnoGAN (the JAX package's
``training/adversarial.py``):

- D step: BCE(d_pred_real, 1) + BCE(d_pred_fake, 0), a gradient for D's
  parameters only;
- G step: the forward again with the new D, w_rec * |fake - x| + BCE(
  d_pred_fake, 1) + w_feat * |d_features_fake - d_features_real|, a
  gradient for G's parameters only.

Each has its own Adam (b1 0.5, eps 1e-8, as ``optax.adam``). Both forwards
run in train mode, so every BatchNorm updates its running statistics once
per module call, in the order flax's do: per step G's twice, D's four
times. Images are NHWC (B, H, W, C), as the JAX trainer takes them.

The model is built on ``device``, a CUDA device unless the caller asks for
the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.anogan import AnoGAN
from .losses import bce_with_logits


@dataclasses.dataclass
class AnoGANState:
    model: AnoGAN
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0


def _apply(loss: torch.Tensor, module: torch.nn.Module,
           opt: torch.optim.Optimizer) -> None:
    """One optimizer step of ``module``'s parameters on the gradient of
    ``loss`` with respect to them alone."""
    params = list(module.parameters())
    for p, g in zip(params, torch.autograd.grad(loss, params)):
        p.grad = g
    opt.step()


@dataclasses.dataclass
class AnoGANTrainer:
    learning_rate: float = 2e-4
    b1: float = 0.5
    w_rec: float = 50.0
    w_feat: float = 1.0
    seed: int = 0
    in_channels: int = 1
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device "
                               "available (ask for the CPU explicitly)")
        self.model = AnoGAN(
            self.in_channels, self.in_channels,
            generator=torch.Generator().manual_seed(self.seed),
        ).to(self.device)

    def init(self) -> AnoGANState:
        """The model and one Adam for G, one for D."""
        def adam(module):
            return torch.optim.Adam(module.parameters(),
                                    lr=self.learning_rate,
                                    betas=(self.b1, 0.999), eps=1e-8)

        return AnoGANState(self.model, adam(self.model.G),
                           adam(self.model.D))

    def d_loss(self, x: torch.Tensor) -> torch.Tensor:
        out = self.model(x)
        real, fake = out["d_pred_real"], out["d_pred_fake"]
        return (bce_with_logits(real, torch.ones_like(real))
                + bce_with_logits(fake, torch.zeros_like(fake)))

    def g_loss(self, x: torch.Tensor):
        """-> (loss, reconstruction term)."""
        out = self.model(x)
        rec = torch.mean(torch.abs(out["fake_images"] - x))
        fake = out["d_pred_fake"]
        adv = bce_with_logits(fake, torch.ones_like(fake))
        feat = torch.mean(torch.abs(out["d_features_fake"]
                                    - out["d_features_real"]))
        return self.w_rec * rec + adv + self.w_feat * feat, rec

    def make_train_step(self):
        """``step(state, images) -> {"d_loss", "g_loss", "rec"}``: the D
        step, then the G step."""

        def step(state: AnoGANState, images: torch.Tensor) -> dict:
            state.model.train()
            x = images.permute(0, 3, 1, 2)
            d_loss = self.d_loss(x)
            _apply(d_loss, state.model.D, state.opt_d)
            g_loss, rec = self.g_loss(x)
            _apply(g_loss, state.model.G, state.opt_g)
            state.step += 1
            return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                    "rec": rec.detach()}

        return step
