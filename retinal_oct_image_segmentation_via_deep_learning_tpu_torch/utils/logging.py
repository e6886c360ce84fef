"""Host-side metric logging to JSONL and the probability-map export (the
JAX package's ``utils/logging.py``)."""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

import numpy as np


class MetricLogger:
    """Appends one JSON line per record to ``path`` (if given) and prints
    ``key=value`` pairs (if ``also_print``)."""

    def __init__(self, path: str | None = None, also_print: bool = True):
        self.path = path
        self.also_print = also_print
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, record: Mapping[str, Any]) -> None:
        rec = {k: _to_py(v) for k, v in record.items()}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self.also_print:
            print("  ".join(f"{k}={_fmt(v)}" for k, v in rec.items()),
                  flush=True)


def _to_py(v):
    """numpy scalars and arrays, and torch tensors, to plain Python."""
    if hasattr(v, "item") and getattr(v, "ndim", None) == 0:
        return v.item()
    if hasattr(v, "tolist"):
        return v.tolist()
    return v


def _fmt(v):
    return f"{v:.5g}" if isinstance(v, float) else v


def export_prob_maps(probs, directory: str, names=None,
                     fmt: str = "%.8g") -> None:
    """Write each (H, W) probability map of ``probs`` (B, H, W) as a text
    file in ``directory``: ``names[i]``, or ``prob_0000.txt`` and on (the
    reference's inference output)."""
    os.makedirs(directory, exist_ok=True)
    probs = np.asarray(probs.cpu() if hasattr(probs, "cpu") else probs)
    for i in range(probs.shape[0]):
        name = names[i] if names else f"prob_{i:04d}.txt"
        np.savetxt(os.path.join(directory, name), probs[i], fmt=fmt)
