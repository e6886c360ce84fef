"""Host -> device input pipeline: a producer thread copies batches ahead of
the consumer (the JAX package's ``training/input_pipeline.py``).

Each batch (a tuple of tensors) is moved to ``device`` in the producer
thread: CPU tensors bound for a CUDA device are pinned first and copied with
``non_blocking=True``, so the copy of batch k+1 overlaps the step on batch k.
The copies are issued on the device's default stream, the stream the
consumer's step runs on, so the step sees the finished copy without an
explicit wait. An exception in the producer is re-raised at the consumer's
``next()``.

With tracing on (``utils/profiling``), the producer's copy and transform
of batch k are the spans ``input.copy`` and ``input.prepare`` and the
consumer's wait for it ``input.wait``, all with id k; each batch the
consumer takes adds the rows and bytes that were moved to the device for
it to ``input.rows_copied`` and ``input.bytes_copied``.
"""

from __future__ import annotations

import queue
import threading

import torch

from ..utils.profiling import annotate, count


def _moved(batch, device: torch.device) -> tuple[int, int]:
    """(rows, bytes) of ``batch`` that ``to_device`` moves to ``device``:
    the leading dimension of the first tensor that moves, and the bytes of
    every tensor that moves."""
    moving = [t for t in batch if t.device != device]
    if not moving:
        return 0, 0
    first = moving[0]
    rows = first.shape[0] if first.dim() else 1
    return rows, sum(t.nbytes for t in moving)


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
                for k, batch in enumerate(batches):
                    size = _moved(batch, device)
                    with annotate("input.copy", k):
                        moved = to_device(batch, device)
                    if transform:
                        with annotate("input.prepare", k):
                            moved = transform(moved)
                    self._q.put((moved, size))
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._END)

        self._taken = 0
        self._thread = threading.Thread(target=produce, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with annotate("input.wait", self._taken):
            item = self._q.get()
        if item is self._END:
            self._thread.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        self._taken += 1
        moved, (rows, nbytes) = item
        count("input.rows_copied", rows)
        count("input.bytes_copied", nbytes)
        return moved


def prefetch_to_device(batches, device, transform=None, depth: int = 2):
    """``for x, y in prefetch_to_device(ds.epoch(i), "cuda"): ...``"""
    return DevicePrefetcher(batches, device, transform=transform, depth=depth)
