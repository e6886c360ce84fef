"""Train state: the model, its optimizer and schedule, and a step counter.

``make_optimizer`` is the JAX package's optax recipe on ``torch.optim``:

* adam: ``Adam`` (eps 1e-8 outside the square root, bias-corrected, as
  ``optax.adam``);
* adamw: ``AdamW``, which decays by lr * wd * p as ``optax.adamw`` does;
* sgd: ``SGD`` with momentum (optax's trace: buf = g + momentum * buf);
* adadelta: ``Adadelta`` with optax's rho 0.9, eps 1e-6;
* ``optax.warmup_cosine_decay_schedule`` as a ``LambdaLR`` on the same
  curve (step 0 is the first update, as optax's count);
* ``optax.clip_by_global_norm`` before the update, as ``clip_grad_norm_``.

JAX's state is immutable; here ``apply_gradients`` updates the parameters
in place and advances ``step``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
from torch import nn

from ..config import OptimConfig


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's curve: linear from init to peak over ``warmup_steps``, then
    cosine to ``end_value`` at ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, span)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / span))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def make_optimizer(cfg: OptimConfig, params):
    """-> (optimizer, LambdaLR or None) for ``params``."""
    params = list(params)
    lr = cfg.learning_rate
    if cfg.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(cfg.b1, cfg.b2),
                               eps=1e-8)
    elif cfg.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(cfg.b1, cfg.b2),
                                eps=1e-8, weight_decay=cfg.weight_decay)
    elif cfg.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, momentum=cfg.momentum)
    elif cfg.optimizer == "adadelta":
        opt = torch.optim.Adadelta(params, lr=lr, rho=0.9, eps=1e-6)
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer}")
    sched = None
    if cfg.warmup_steps or cfg.decay_steps:
        curve = warmup_cosine_decay_schedule(
            0.0, lr, max(cfg.warmup_steps, 1),
            max(cfg.decay_steps or cfg.warmup_steps + 1, 2),
            lr * cfg.lr_min_ratio,
        )
        sched = torch.optim.lr_scheduler.LambdaLR(
            opt, lambda step: curve(step) / lr if lr else 0.0)
    return opt, sched


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler | None = None
    grad_clip_norm: float | None = None
    step: int = 0

    def apply_gradients(self) -> None:
        """Clip (if configured), update, advance the schedule and step."""
        if self.grad_clip_norm:
            nn.utils.clip_grad_norm_(self.model.parameters(),
                                     self.grad_clip_norm)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        self.step += 1

    def state_dict(self) -> dict:
        out = {"model": self.model.state_dict(),
               "optimizer": self.optimizer.state_dict(), "step": self.step}
        if self.scheduler is not None:
            out["scheduler"] = self.scheduler.state_dict()
        return out

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])
        self.step = int(sd["step"])


def create_train_state(model: nn.Module, optim_cfg: OptimConfig) -> TrainState:
    opt, sched = make_optimizer(optim_cfg, model.parameters())
    return TrainState(model, opt, sched, optim_cfg.grad_clip_norm)
