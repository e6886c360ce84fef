"""Spans, counters and traces of the port (the JAX package's
``utils/profiling.py``).

Tracing is off until ``tracing()`` turns it on, and then on for the
process (every thread):

- ``tracing(on=True)``: the switch, a context manager; it restores the
  previous state on exit.
- ``annotate(name, id=None)``: the program's span. Off, it returns one
  shared no-op context after a single flag check. On, it is a profiler
  range named ``octseg: <name>`` (``PREFIX``), on the same clock as the
  device's kernels in a ``torch.profiler`` trace, carrying ``id`` as its
  input (seen where the profiler records inputs: ``record_shapes``), and
  an NVTX range on a CUDA host. Spans nest on each thread; spans of one
  volume, or of one batch, share an id.
- ``count(name, n=1)``: adds ``n`` to a counter while tracing is on;
  ``counters()`` is a copy of them, ``reset_counters()`` clears them.
- ``trace(log_dir)``: a ``torch.profiler`` trace of the block (host and,
  where there is a card, device activity) with tracing on, written to
  ``log_dir`` as a Chrome/TensorBoard trace: the program's spans beside
  the kernels, from every thread (``all_threads``).
- ``all_threads()``: the profiler setting that records every thread's
  ranges; a profiler started without it records only the thread that
  started it and the autograd engine's.
- ``sync(tree)``: wait for the devices of a tree's tensors.
- ``count_params``: parameter count.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from .debug import _leaves

PREFIX = "octseg: "

_on = False
_OFF = contextlib.nullcontext()
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()


@contextlib.contextmanager
def tracing(on: bool = True):
    """Turn the program's spans and counters on (or off) for the block."""
    global _on
    was, _on = _on, on
    try:
        yield
    finally:
        _on = was


class _Span:
    """A profiler range (with ``id`` as its input) and an NVTX range."""

    __slots__ = ("name", "args", "handle", "nvtx")

    def __init__(self, name: str, id):
        self.name = PREFIX + name
        self.args = () if id is None else (int(id),)

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name, *self.args)
        self.nvtx = torch.cuda.is_available()
        if self.nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def annotate(name: str, id: int | None = None):
    """``with annotate("serve.forward", k):`` a span of the program (the
    module docstring); a shared no-op while tracing is off."""
    if not _on:
        return _OFF
    return _Span(name, id)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on (from any
    thread)."""
    if _on:
        with _counts_lock:
            _counts[name] = _counts.get(name, 0) + n


def counters() -> dict[str, int]:
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _counts_lock:
        _counts.clear()


def all_threads():
    """``experimental_config`` for ``torch.profiler.profile`` that records
    the ranges and operations of every thread (the input pipeline's
    producer among them), or None where this PyTorch has no such
    setting."""
    try:
        return torch.profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with tracing(), torch.profiler.profile(
            activities=activities, record_shapes=True,
            experimental_config=all_threads(),
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield


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
