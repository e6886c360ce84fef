"""Tracing and profiling helpers (the JAX package's
``utils/profiling.py``).

- ``trace(log_dir)``: a ``torch.profiler`` trace of the block (host and,
  where there is a card, device activity), written to ``log_dir`` as a
  Chrome/TensorBoard trace.
- ``annotate(name)``: a named region: ``record_function`` in the
  profiler's trace, and an NVTX range on a CUDA host.
- ``step_timer``: wall-clock time of a block into a dict.
- ``sync(tree)``: wait for the devices of a tree's tensors.
- ``count_params`` / ``flops_estimate``: parameter count, and the FLOPs
  of one call as ``torch.utils.flop_counter.FlopCounterMode`` counts them
  (None where it cannot count).
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from .debug import _leaves


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            torch.cuda.nvtx.range_push(name)
            try:
                yield
            finally:
                torch.cuda.nvtx.range_pop()
        else:
            yield


@contextlib.contextmanager
def step_timer(record: dict, key: str = "step_time_s"):
    t0 = time.perf_counter()
    yield
    record[key] = time.perf_counter() - t0


def sync(tree):
    """Wait until every CUDA device holding a tensor of ``tree`` (a
    module, a tensor or a nested dict or list) is done; -> ``tree``."""
    devices = {t.device for _, t in _leaves(tree) if t.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
    return tree


def count_params(params) -> int:
    """Parameters of a module, or elements of a tree of tensors."""
    if isinstance(params, torch.nn.Module):
        return sum(p.numel() for p in params.parameters())
    return sum(t.numel() for _, t in _leaves(params))


def flops_estimate(fn, *args) -> float | None:
    """FLOPs of ``fn(*args)`` by ``FlopCounterMode`` (matmuls and
    convolutions, forward and any backward run inside), or None where it
    cannot count."""
    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args)
        return float(counter.get_total_flops())
    except Exception:  # an op the counter cannot trace: no estimate
        return None
