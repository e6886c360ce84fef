"""Checkpoints with best-metric retention, and early stopping (the JAX
package's ``training/checkpoint.py``).

A checkpoint is one ``torch.save`` file per step holding the train state
(model, optimizer, schedule, step) and its metrics. The manager keeps the
``keep`` checkpoints with the lowest ``val_loss`` (a checkpoint saved
without one ranks last), as the Orbax manager there does with
``best_fn=val_loss, best_mode="min"``. Files are read back with
``torch.load(weights_only=True)``: a checkpoint can hold tensors and plain
containers, never pickled code.
"""

from __future__ import annotations

import os
import re

import torch

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 1):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._metrics: dict[int, float] = {}
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                self._metrics[int(m.group(1))] = self._load(
                    int(m.group(1)))["metrics"].get("val_loss", float("inf"))

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pt")

    def _load(self, step: int) -> dict:
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def save(self, step: int, state, metrics: dict | None = None) -> None:
        """Write ``state.state_dict()`` at ``step``, then drop all but the
        ``keep`` best checkpoints."""
        metrics = dict(metrics or {})
        tmp = self._path(step) + ".tmp"
        torch.save({"state": state.state_dict(), "metrics": metrics}, tmp)
        os.replace(tmp, self._path(step))
        self._metrics[step] = float(metrics.get("val_loss", float("inf")))
        ranked = sorted(self._metrics, key=lambda s: (self._metrics[s], s))
        for old in ranked[self.keep:]:
            os.remove(self._path(old))
            del self._metrics[old]

    def best_step(self) -> int | None:
        if not self._metrics:
            return None
        return min(self._metrics, key=lambda s: (self._metrics[s], s))

    def latest_step(self) -> int | None:
        return max(self._metrics) if self._metrics else None

    def _restore(self, step: int | None, state):
        if step is None:
            return None
        state.load_state_dict(self._load(step)["state"])
        return state

    def restore_best(self, state):
        """Load the best checkpoint into ``state`` (a ``TrainState``) and
        return it; None if there is no checkpoint."""
        return self._restore(self.best_step(), state)

    def restore_latest(self, state):
        return self._restore(self.latest_step(), state)


class EarlyStopping:
    """Best-validation tracking with patience (Keras ``EarlyStopping``
    semantics, as in the JAX package)."""

    def __init__(self, patience: int | None):
        self.patience = patience
        self.best = float("inf")
        self.best_step = -1
        self.bad_epochs = 0

    def update(self, step: int, val_loss: float) -> bool:
        """Record a validation result; True if training should stop."""
        if val_loss < self.best:
            self.best = val_loss
            self.best_step = step
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.patience is not None and self.bad_epochs >= self.patience
