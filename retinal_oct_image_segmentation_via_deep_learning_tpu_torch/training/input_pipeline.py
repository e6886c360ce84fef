"""Host -> device input pipeline: a producer thread copies batches ahead of
the consumer (the JAX package's ``training/input_pipeline.py``).

Each batch (a tuple of tensors) is moved to ``device`` in the producer
thread: CPU tensors bound for a CUDA device are pinned first and copied with
``non_blocking=True``, so the copy of batch k+1 overlaps the step on batch k.
The copies are issued on the device's default stream, the stream the
consumer's step runs on, so the step sees the finished copy without an
explicit wait. An exception in the producer is re-raised at the consumer's
``next()``.
"""

from __future__ import annotations

import queue
import threading

import torch


def to_device(batch, device: torch.device):
    """Move every tensor of a tuple batch to ``device`` (pinned,
    non-blocking copies from the host to a CUDA device)."""
    out = []
    for t in batch:
        if t.device != device:
            if device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(device, non_blocking=True)
        out.append(t)
    return tuple(out)


class DevicePrefetcher:
    """Wrap an iterator of host batches; yield batches on ``device``.

    transform: optional callable applied to each moved batch in the
      producer thread (e.g. the trainer's preprocessing).
    depth: queue depth (1 = classic double buffering).
    """

    _END = object()

    def __init__(self, batches, device, transform=None, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None

        def produce():
            try:
                for batch in batches:
                    moved = to_device(batch, device)
                    self._q.put(transform(moved) if transform else moved)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._END)

        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._END:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch_to_device(batches, device, transform=None, depth: int = 2):
    """``for x, y in prefetch_to_device(ds.epoch(i), "cuda"): ...``"""
    return DevicePrefetcher(batches, device, transform=transform, depth=depth)
