"""SDNet's composite training step (the JAX package's
``training/sdnet_pipeline.py``): semi-supervised disentanglement.

    L = CE(clean_masks, labels)                      (supervised masks)
      + w_rec * |reconstruction - image|             (reconstruction)
      + w_kl * KL(z_mean, z_logvar)                  (VAE prior)
      + w_z * |z_estimate - sampled_z|               (modality cycle)
      + w_topo * mean(topology_violations)
      + w_cont * mean(continuity_violations)
      + w_curv * mean(relu(curvature_diffs))

over the ``LayerEngine``'s violation terms. Adam (``torch.optim.Adam``, eps
1e-8, as ``optax.adam``); in train mode every BatchNorm normalises with the
batch statistics (K6) and updates its running statistics as flax does, the
modality encoder's twice per step (it runs on the image and on the
reconstruction). Images are NHWC (B, H, W, 1), labels (B, H, W), as the
JAX trainer takes them. The reparameterisation noise is the ``eps`` the
caller gives, or drawn from ``generator``.

The model is built on ``device``, a CUDA device unless the caller asks for
the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.sdnet.layer_engine import relu
from ..models.sdnet.sdnet import SDNet
from .losses import kl_divergence
from .train_state import TrainState


@dataclasses.dataclass
class SDNetTrainer:
    img_size: int = 256
    n_classes: int = 4
    n_anatomical_factors: int = 12
    channels: tuple = (32, 64, 128, 256, 512)
    learning_rate: float = 1e-4
    w_rec: float = 1.0
    w_kl: float = 0.01
    w_z: float = 1.0
    w_topo: float = 0.1
    w_cont: float = 0.01
    w_curv: float = 0.01
    seed: int = 0
    device: torch.device | str = "cuda"

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device "
                               "available (ask for the CPU explicitly)")
        self.model = SDNet(
            img_size=self.img_size, n_classes=self.n_classes,
            n_anatomical_factors=self.n_anatomical_factors,
            channels=tuple(self.channels),
            generator=torch.Generator().manual_seed(self.seed),
        ).to(self.device)

    def init(self) -> TrainState:
        """The model and its Adam state."""
        opt = torch.optim.Adam(self.model.parameters(),
                               lr=self.learning_rate, eps=1e-8)
        return TrainState(self.model, opt)

    def loss_fn(self, images: torch.Tensor, labels: torch.Tensor, *,
                eps: torch.Tensor | None = None,
                generator: torch.Generator | None = None,
                train: bool = True):
        """-> (total loss, {term: value}), the terms still in the graph as
        JAX's aux outputs are; in train mode the BatchNorms update their
        running statistics."""
        self.model.train(train)
        x = images.permute(0, 3, 1, 2)
        out = self.model(x, eps=eps, generator=generator)

        masks = out["clean_masks"]
        # jnp.clip's gradient: maximum then minimum, half at a tie
        masks = torch.minimum(torch.maximum(masks, masks.new_tensor(1e-7)),
                              masks.new_tensor(1.0))
        classes = torch.arange(masks.shape[1], device=labels.device)
        onehot = (labels.unsqueeze(1) == classes.view(1, -1, 1, 1)).float()
        ce = -torch.mean(torch.sum(onehot * torch.log(masks), dim=1))

        rec = torch.mean(torch.abs(out["reconstruction"] - x))
        kl = kl_divergence(out["z_mean"], out["z_logvar"])
        zcycle = torch.mean(torch.abs(out["z_estimate"] - out["sampled_z"]))
        el = out["extra_losses"]
        topo = torch.mean(el["topology_violations"])
        cont = torch.mean(el["continuity_violations"])
        curv = torch.mean(relu(el["curvature_diffs"]))

        total = (ce + self.w_rec * rec + self.w_kl * kl + self.w_z * zcycle
                 + self.w_topo * topo + self.w_cont * cont
                 + self.w_curv * curv)
        metrics = {"ce": ce, "rec": rec, "kl": kl, "z_cycle": zcycle,
                   "topology": topo, "continuity": cont, "curvature": curv}
        return total, metrics

    def make_train_step(self):
        """``step(state, images, labels, *, eps=None, generator=None) ->
        (loss, metrics)``: one Adam step in train mode."""

        def step(state: TrainState, images, labels, *, eps=None,
                 generator=None):
            state.optimizer.zero_grad(set_to_none=True)
            loss, metrics = self.loss_fn(images, labels, eps=eps,
                                         generator=generator)
            loss.backward()
            state.apply_gradients()
            return loss.detach(), {k: v.detach() for k, v in metrics.items()}

        return step
