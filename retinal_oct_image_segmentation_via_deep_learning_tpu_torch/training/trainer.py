"""Trainer: train steps, validation, best checkpoint and early stopping on
one device or over the data axis of a mesh (the JAX package's
``training/trainer.py``).

Per epoch: train steps (batches copied ahead by ``input_pipeline``) ->
validation loss and per-class Dice -> checkpoint -> early stopping. With
``cfg.packed_train`` the U-Net trains through
``packed_unet.make_packed_train_step`` (the CUDA kernels); otherwise the
registry model runs in train mode under autocast to ``cfg.compute_dtype``
(parameters stay float32), its BatchNorms through ``ops/fused_bn``.

``evaluate`` runs the device metric suite (``metrics/volume.py``) over a
dataset, through the model or any ``predict_fn`` (a quantized graph).

The trainer runs on ``device``, a CUDA device unless the caller asks for the
CPU. Given a mesh (``mesh=`` or ``cfg.mesh_shape``) whose "data" axis has
more than one rank, each rank of the process group runs this trainer on
the same global batches: the step (the model's or the packed one) takes
this rank's shard of the batch, runs the model under
``parallel.collectives.data_parallel`` (train-mode BatchNorm and the
losses over the global batch), sums the gradients over the ranks and
applies the same update everywhere; the parameters start from rank 0's.
A step on two ranks with half the batch each is the one-rank step on the
whole batch. Validation runs the whole batch on every rank; rank 0 writes
the checkpoints.

``remat="full"`` (or ``OCTSEG_TRAIN_REMAT=full``) recomputes the whole
forward in the backward (``torch.utils.checkpoint``); the buffers are put
back after the backward, so the running statistics move once a step. It
keeps no activations between the forward and the backward, but the
recompute holds them all again while the backward runs, so the step's
peak memory does not fall (``chip_smoke.py`` phase 35 prints both peaks).
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import os
import time
from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..config import TrainConfig
from ..metrics.region import per_class_dice
from ..metrics.volume import (
    metrics_from_confusion,
    volume_boundary_metrics,
    volume_confusion,
)
from ..ops.preprocess import preprocess
from ..parallel.collectives import data_group, data_parallel, sum_gradients
from ..parallel.mesh import SPACE_AXIS, Mesh, create_mesh
from ..parallel.sharding import shard_batch, shard_params
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


REMATS = (None, "full")


def make_train_step(loss_fn: Callable, class_weights=None,
                    dtype: torch.dtype = torch.bfloat16,
                    remat: str | None = None, mesh: Mesh | None = None):
    """``train_step(state, images, labels) -> loss``: the model in train
    mode, one optimizer step; BN running stats update in the forward.

    ``remat="full"`` (default ``OCTSEG_TRAIN_REMAT``) recomputes the whole
    forward in the backward. With a ``mesh`` whose data axis has more than
    one rank the step is data-parallel over the global batch it is given
    (the module docstring)."""
    remat = remat or os.environ.get("OCTSEG_TRAIN_REMAT") or None
    if remat not in REMATS:
        raise ValueError(f"remat={remat!r}: one of {REMATS}")
    group = data_group(mesh)

    def forward(model, images):
        if remat is None:
            return nhwc_logits(model, images, dtype)
        return checkpoint(nhwc_logits, model, images, dtype,
                          use_reentrant=False)

    def train_step(state: TrainState, images, labels):
        if group is not None:
            images, labels = shard_batch(mesh, (images, labels))
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        with data_parallel(group):
            logits = forward(state.model, images)
            # the recompute runs train-mode BatchNorm again: the running
            # statistics keep the forward's update
            kept = [b.clone() for b in state.model.buffers()] if remat \
                else []
            loss = loss_fn(logits, labels, class_weights)
            loss.backward()
        with torch.no_grad():
            for b, k in zip(state.model.buffers(), kept):
                b.copy_(k)
        if group is not None:
            sum_gradients(state.model, group)
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
    def __init__(self, cfg: TrainConfig, device: torch.device | str = "cuda",
                 mesh: Mesh | None = None):
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {self.device}: no CUDA device "
                               "available (ask for the CPU explicitly)")
        if mesh is None and cfg.mesh_shape:
            mesh = create_mesh(**dict(cfg.mesh_shape))
        if mesh is not None and mesh.axis_size(SPACE_AXIS) > 1:
            raise ValueError(
                f"Trainer: mesh {mesh.shape}: the trainer shards the batch "
                "over 'data' only; a space axis is for inference "
                "(parallel.halo.spatial_shard_infer)")
        self.mesh = mesh
        self._group = data_group(mesh)
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
            if cfg.checkpoint_dir and (self._group is None
                                       or mesh.coords == (0, 0)) else None
        )
        self.history: list[dict] = []

    # -- setup ------------------------------------------------------------
    def init_state(self) -> TrainState:
        """The train state of ``self.model``; under data parallelism its
        parameters and buffers are rank 0's."""
        if self._group is not None:
            shard_params(self.mesh, self.model)
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
                remat=cfg.packed_train == "remat", mesh=self.mesh,
            )
        return make_train_step(self.loss_fn, self.class_weights, self.dtype,
                               mesh=self.mesh)

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
