"""Persistent serving loop with request micro-batching.

A background thread owns one forward at a fixed batch size; clients submit
single B-scans from any thread, and the loop coalesces whatever arrived
within ``max_wait_ms`` into one padded batch, runs the device once, and
resolves per-request futures. Padding rows are dropped; ``close()`` rejects
new submits and serves what was already queued.

The forward is any ``fn(images) -> labels`` on (B, H, W, C) float32 tensors
on ``device``; it runs under ``torch.inference_mode()``.

Counters, always kept: ``batches_run`` and ``requests_served``;
``batch_fill``, the requests in each batch run, summed (over
``batches_run`` and ``batch_size``: how full the batches were); and
``queue_wait_s``, each served request's seconds from ``submit`` to the
start of its batch, summed.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np
import torch


class ServingLoop:
    def __init__(self, forward: Callable, image_shape, *,
                 device: torch.device | str, batch_size: int = 8,
                 max_wait_ms: float = 2.0):
        self.batch_size = batch_size
        self.image_shape = tuple(image_shape)  # (H, W, C)
        self.device = torch.device(device)
        self.max_wait = max_wait_ms / 1e3
        self._forward = forward
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._started = False
        self.batches_run = 0
        self.requests_served = 0
        self.batch_fill = 0
        self.queue_wait_s = 0.0

    # -- client API ---------------------------------------------------------

    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def submit(self, image: np.ndarray) -> Future:
        """Queue one (H, W, C) image; resolves to its (H, W) label map."""
        if self._stop.is_set():
            raise RuntimeError("ServingLoop is closed")
        if tuple(image.shape) != self.image_shape:
            raise ValueError(
                f"expected image shape {self.image_shape}, got {image.shape}"
            )
        fut: Future = Future()
        self._q.put((np.asarray(image, np.float32), fut,
                     time.perf_counter()))
        return fut

    def predict(self, image: np.ndarray):
        return self.submit(image).result()

    def run_batch(self, batch: np.ndarray) -> np.ndarray:
        """Run the forward on one (batch_size, H, W, C) array; returns the
        labels on the host (synchronises the device)."""
        x = torch.from_numpy(np.ascontiguousarray(batch, np.float32))
        with torch.inference_mode():
            return self._forward(x.to(self.device)).cpu().numpy()

    def warmup(self):
        """Run one zero batch (building the kernels on first use) and
        synchronise, before taking traffic."""
        self.run_batch(np.zeros((self.batch_size,) + self.image_shape,
                                np.float32))
        return self

    def close(self):
        """Reject new submits, drain-serve already-queued requests, stop."""
        self._stop.set()
        self._q.put(None)  # wake the loop
        if self._started:
            self._thread.join()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    # -- loop ---------------------------------------------------------------

    def _collect(self):
        """Block for the first request, then drain up to batch_size within
        max_wait."""
        first = self._q.get()
        if first is None:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_wait
        while len(items) < self.batch_size:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _serve(self, items):
        started = time.perf_counter()
        images = [img for img, _, _ in items]
        pad = np.zeros(self.image_shape, np.float32)
        images += [pad] * (self.batch_size - len(images))
        try:
            out = self.run_batch(np.stack(images))
        except Exception as e:  # resolve the futures with the error
            for _, fut, _ in items:
                fut.set_exception(e)
            return
        self.batches_run += 1
        self.batch_fill += len(items)
        self.queue_wait_s += sum(started - t for _, _, t in items)
        for i, (_, fut, _) in enumerate(items):
            fut.set_result(out[i])
            self.requests_served += 1

    def _loop(self):
        while not self._stop.is_set():
            items = self._collect()
            if items:
                self._serve(items)
        # drain-serve requests that were queued before close()
        pending = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                pending.append(item)
        for i in range(0, len(pending), self.batch_size):
            self._serve(pending[i : i + self.batch_size])
