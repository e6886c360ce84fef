"""Trainer: train steps, validation, best checkpoint and early stopping on
one device (the JAX package's ``training/trainer.py``).

Per epoch: train steps (batches copied ahead by ``input_pipeline``) ->
validation loss and per-class Dice -> checkpoint -> early stopping. With
``cfg.packed_train`` the U-Net trains through
``packed_unet.make_packed_train_step`` (the CUDA kernels); otherwise the
registry model runs in train mode under autocast to ``cfg.compute_dtype``
(parameters stay float32), its BatchNorms through ``ops/fused_bn``.

``evaluate`` runs the device metric suite (``metrics/volume.py``) over a
dataset, through the model or any ``predict_fn`` (a quantized graph).

The trainer runs on ``device``, a CUDA device unless the caller asks for the
CPU. Not ported yet: the device mesh (the parallel slice) and
``OCTSEG_TRAIN_REMAT`` (ROADMAP.md, Queue A item 8).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import time
from typing import Any, Callable

import torch

from ..config import TrainConfig
from ..metrics.region import per_class_dice
from ..metrics.volume import (
    metrics_from_confusion,
    volume_boundary_metrics,
    volume_confusion,
)
from ..ops.preprocess import preprocess
from ..registry import get_model
from ..utils.dtype import resolve_dtype
from .checkpoint import CheckpointManager, EarlyStopping
from .input_pipeline import prefetch_to_device, to_device
from .losses import get_loss
from .train_state import TrainState, create_train_state


def _autocast(device: torch.device, dtype: torch.dtype):
    if dtype == torch.float32:
        return contextlib.nullcontext()
    return torch.autocast(device.type, dtype=dtype)


def nhwc_logits(model, images: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """NHWC images -> NHWC logits of an NCHW model, computed in ``dtype``."""
    with _autocast(images.device, dtype):
        return model(images.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def make_train_step(loss_fn: Callable, class_weights=None,
                    dtype: torch.dtype = torch.bfloat16):
    """``train_step(state, images, labels) -> loss``: the model in train
    mode, one optimizer step; BN running stats update in the forward."""

    def train_step(state: TrainState, images, labels):
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(nhwc_logits(state.model, images, dtype), labels,
                       class_weights)
        loss.backward()
        state.apply_gradients()
        return loss.detach()

    return train_step


def make_eval_step(loss_fn: Callable, num_classes: int, class_weights=None,
                   dtype: torch.dtype = torch.bfloat16):
    """``eval_step(state, images, labels) -> (loss, per-class Dice)`` with
    the running statistics."""

    @torch.no_grad()
    def eval_step(state: TrainState, images, labels):
        state.model.eval()
        logits = nhwc_logits(state.model, images, dtype)
        loss = loss_fn(logits, labels, class_weights)
        dice = per_class_dice(labels, logits.argmax(-1), num_classes)
        return loss, dice

    return eval_step


class Trainer:
    def __init__(self, cfg: TrainConfig, device: torch.device | str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device "
                               "available (ask for the CPU explicitly)")
        self.dtype = resolve_dtype(cfg.compute_dtype)
        self.model = get_model(
            cfg.model.name,
            in_channels=cfg.model.in_channels,
            num_classes=cfg.model.num_classes,
            seed=cfg.seed,
            **cfg.model.kwargs,
        ).to(self.device)
        self.loss_fn = get_loss(cfg.loss)
        self.class_weights = (
            torch.tensor(cfg.class_weights, dtype=torch.float32,
                         device=self.device)
            if cfg.class_weights else None
        )
        self.ckpt = (
            CheckpointManager(cfg.checkpoint_dir, cfg.keep_checkpoints)
            if cfg.checkpoint_dir else None
        )
        self.history: list[dict] = []

    # -- setup ------------------------------------------------------------
    def init_state(self) -> TrainState:
        return create_train_state(self.model, self.cfg.optim)

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        d = self.cfg.data
        if d.flatten_retina or d.denoise or d.normalize:
            images = preprocess(images, flatten=d.flatten_retina,
                                denoise=d.denoise, normalize=d.normalize)
        return images

    def _prepare(self, batch):
        images, labels = to_device(batch, self.device)
        return self._preprocess(images.float()), labels.long()

    def train_step_fn(self):
        """The step ``fit`` runs: packed (CUDA kernels) or the model's."""
        cfg = self.cfg
        if cfg.packed_train:
            if cfg.model.name != "unet":
                raise ValueError(
                    "packed_train supports only the flagship 'unet' model, "
                    f"got {cfg.model.name!r}"
                )
            from .packed_unet import make_packed_train_step

            return make_packed_train_step(
                self.loss_fn, self.class_weights,
                remat=cfg.packed_train == "remat",
            )
        return make_train_step(self.loss_fn, self.class_weights, self.dtype)

    # -- loops ------------------------------------------------------------
    def fit(self, train_ds, val_ds=None, state: TrainState | None = None):
        """Train ``cfg.num_epochs`` epochs; returns the state with the best
        validation loss (the last state without ``val_ds``)."""
        cfg = self.cfg
        if state is None:
            # the JAX trainer draws a sample batch to initialise; drawing it
            # here too keeps a shuffling dataset's batch order the same
            next(iter(train_ds.epoch(0)))
            state = self.init_state()
        train_step = self.train_step_fn()
        eval_step = make_eval_step(self.loss_fn, cfg.model.num_classes,
                                   self.class_weights, self.dtype)
        stopper = EarlyStopping(cfg.early_stop_patience)
        best = copy.deepcopy(state.state_dict()) if val_ds is not None \
            else None

        for epoch in range(cfg.num_epochs):
            t0 = time.perf_counter()
            train_loss = 0.0
            nsteps = 0
            # steps_per_epoch bounds the SOURCE iterator, so the producer
            # thread always drains and exits
            epoch_iter = train_ds.epoch(epoch)
            if cfg.steps_per_epoch:
                epoch_iter = itertools.islice(epoch_iter, cfg.steps_per_epoch)
            for images, labels in prefetch_to_device(
                    epoch_iter, self.device, transform=self._prepare):
                loss = train_step(state, images, labels)
                train_loss += float(loss)
                nsteps += 1
            record: dict[str, Any] = {
                "epoch": epoch,
                "train_loss": train_loss / max(nsteps, 1),
                "time_s": time.perf_counter() - t0,
            }

            if val_ds is not None and (epoch + 1) % cfg.eval_every_epochs == 0:
                vloss, vdice, vn = 0.0, None, 0
                for batch in val_ds.epoch(epoch):
                    loss, dice = eval_step(state, *self._prepare(batch))
                    vloss += float(loss)
                    vdice = dice if vdice is None else vdice + dice
                    vn += 1
                record["val_loss"] = vloss / max(vn, 1)
                record["val_dice"] = (
                    (vdice / max(vn, 1)).tolist() if vdice is not None
                    else None
                )
                if self.ckpt:
                    self.ckpt.save(epoch, state,
                                   {"val_loss": record["val_loss"]})
                if record["val_loss"] < stopper.best:
                    best = copy.deepcopy(state.state_dict())
                if stopper.update(epoch, record["val_loss"]):
                    self.history.append(record)
                    break
            self.history.append(record)
        if best is not None:
            state.load_state_dict(best)
        return state

    @torch.no_grad()
    def evaluate(self, state: TrainState, dataset, epoch: int = 0,
                 contour_metrics: bool = True, max_points: int = 1024,
                 predict_fn=None) -> dict:
        """The metric suite over ``dataset.epoch(epoch)``, as the JAX
        trainer's ``evaluate``: per-class Dice, IoU, sensitivity,
        specificity and precision, the pixel accuracy and the confusion
        matrix from one aggregated confusion count; with
        ``contour_metrics``, per-class HD95 and ASSD (averaged over the
        slices where the class is in both masks) and the thickness and
        vascularity-index differences (averaged over all slices).

        ``predict_fn(state, images) -> (B, H, W) labels`` replaces the
        model's forward, e.g. with a quantized graph. Returns numpy arrays
        (the confusion counts int64) and a float ``pixel_accuracy``."""
        predict_fn = predict_fn or self.predict
        nc = self.cfg.model.num_classes
        cm = None
        sums: dict[str, torch.Tensor] = {}
        n_slices = 0
        for images, labels in dataset.epoch(epoch):
            preds = predict_fn(state, images)
            labels = torch.as_tensor(labels).to(preds.device)
            counts = volume_confusion(labels, preds, nc)
            cm = counts if cm is None else cm + counts
            if not contour_metrics:
                continue
            b = volume_boundary_metrics(labels, preds, nc, max_points)
            n_slices += labels.shape[0]
            add = {"valid": b["valid"].double(),
                   "thickness_diff": b["thickness_diff"].double(),
                   "vi_diff": b["vi_diff"].double()}
            for k in ("hd95", "assd"):
                add[k] = torch.where(b["valid"], b[k], 0.0).double()
            for k, v in add.items():
                sums[k] = sums.get(k, 0.0) + v.sum(dim=0)
        if cm is None:
            cm = torch.zeros((nc, nc), dtype=torch.int64)
        m = metrics_from_confusion(cm)
        out = {"confusion": cm.cpu().numpy()}
        for k in ("dice", "iou", "sensitivity", "specificity", "precision"):
            out[k] = m[k].cpu().numpy()
        out["pixel_accuracy"] = float(m["pixel_accuracy"])
        if n_slices:
            denom = sums["valid"].clamp_min(1.0)
            out["hd95"] = (sums["hd95"] / denom).cpu().numpy()
            out["assd"] = (sums["assd"] / denom).cpu().numpy()
            for k in ("thickness_diff", "vi_diff"):
                out[k] = (sums[k] / n_slices).cpu().numpy()
            out["contour_valid_slices"] = sums["valid"].cpu().numpy()
        return out

    # -- inference --------------------------------------------------------
    @torch.no_grad()
    def predict(self, state: TrainState, images: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 1) images -> (N, H, W) labels, eval mode."""
        images = self._preprocess(images.to(self.device).float())
        state.model.eval()
        return nhwc_logits(state.model, images, self.dtype).argmax(-1)
