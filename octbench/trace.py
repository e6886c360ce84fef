"""The traced run's reading of ``torch.profiler``: device busy time, device
time by operation name, and the device's idle gaps by what the host was
doing.

The drivers time their host-side spans with ``Spans``, in a traced run
also as ``torch.profiler.record_function`` ranges (prefix ``octbench:``);
a gap in which
no operation (kernel, copy or memset) ran on the device is put down to the
innermost of those spans that was open when the gap began. Only a summary
is kept: no trace is written.
"""

from __future__ import annotations

import contextlib
import time

PREFIX = "octbench: "


class Spans:
    """Host spans by name: total seconds, timed with the host's clock; each
    also a profiler range where ``profiled``."""

    def __init__(self):
        self.total: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str, profiled: bool = False):
        if profiled:
            from torch.profiler import record_function

            ctx = record_function(PREFIX + name)
        else:
            ctx = contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.total[name] = self.total.get(name, 0.0) + time.perf_counter() - t0


def _device_events(prof):
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith(PREFIX) or getattr(e, "is_user_annotation",
                                                 False):
            continue
        out.append(e)
    return out


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(prof, window_s: float, top: int = 10) -> dict:
    """-> {"busy_s", "window_s", "ops": {name: [seconds, count]},
    "device_ops": [[name, seconds]] (the ``top`` largest), "idle_gaps":
    [[host span, seconds]] (the ``top`` largest sums of gaps)}."""
    dev = _device_events(prof)
    ops: dict[str, list] = {}
    spans = []
    for e in dev:
        t = ops.setdefault(e.name, [0.0, 0])
        t[0] += (e.time_range.end - e.time_range.start) / 1e6
        t[1] += 1
        spans.append((e.time_range.start, e.time_range.end))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6
    host = sorted((e.time_range.start, e.time_range.end,
                   e.name[len(PREFIX):]) for e in prof.events()
                  if e.name.startswith(PREFIX)
                  and e.device_type.name == "CPU")
    gaps: dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        label = "outside the harness's spans"
        for s, t, name in host:
            if s > a:
                break
            if t >= a:
                label = name  # the innermost: the latest to open
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    by_time = sorted(ops.items(), key=lambda kv: -kv[1][0])
    return {
        "busy_s": busy_s,
        "window_s": window_s,
        "ops": ops,
        "device_ops": [[name, v[0]] for name, v in by_time[:top]],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                            key=lambda kv: -kv[1])[:top],
    }


def device_seconds(summary: dict, *keys: str) -> tuple[float, int]:
    """(seconds, calls) of the device operations whose names hold any of
    ``keys``."""
    s, n = 0.0, 0
    for name, (t, c) in summary["ops"].items():
        if any(k in name for k in keys):
            s, n = s + t, n + c
    return s, n
