"""Host-side metric logging to JSONL (the JAX package's
``utils/logging.MetricLogger``)."""

from __future__ import annotations

import json
import os
from typing import Any, Mapping


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
