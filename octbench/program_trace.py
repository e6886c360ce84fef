"""The program's own spans in a traced run: device time, host time and the
device's idle gaps by the program's innermost span.

The program opens its spans (``utils/profiling.annotate``) as profiler
ranges named ``octseg: <name>`` while its tracing is on, so they share
the profiler's clock with the device's operations. ``program_summary``
reads one ``torch.profiler`` run, from its raw (Kineto) events: those
carry the link from a device operation to its launching host call, which
the profiler's ``events()`` drop in some PyTorch versions. A profiler
started with the program's ``profiling.all_threads()`` also records the
input pipeline's producer thread.

- a device operation (kernel, copy or memset) is linked by the profiler's
  correlation id to the host call that launched it, and put down to the
  innermost program span open on the launching thread at that moment;
  where that thread has none open (the autograd engine's thread in a
  backward), to the innermost one open on ``main_thread`` then. A kernel
  launched outside any PyTorch operation (the program's ``ctypes``
  kernels) is linked to no operation; it is linked instead to the CUDA
  call that launched it (the same CUPTI correlation id), and put down by
  that call's thread and time alike;
- each idle gap of the device (no operation running) is split by overlap
  over the innermost program spans open on ``main_thread`` during it, the
  rest put down to ``"outside"``.

The readers of ``metrics/`` take what a driver keeps of it in its
``ctx["program"]`` (and the program's counters in ``ctx["counters"]``)
through ``span_device_ms``, ``idle_ms`` and ``counter``.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

from .trace import PREFIX as BENCH_PREFIX
from .trace import _union

# the program's span prefix (``utils/profiling.PREFIX``), spelled out so
# that a trace is read without importing the program
PREFIX = "octseg: "
# host events of the CUDA runtime and driver APIs (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...): their correlation id is CUPTI's,
# shared with the device operation they start
API = "cu"


class Event(NamedTuple):
    """One profiler event; times in us."""
    name: str
    kind: str           # "CPU" for the host, "CUDA" for the card
    thread: int
    start: float
    end: float
    id: int             # the correlation id
    linked: int = 0     # a device event's launching host call's id
    is_async: bool = False
    annotation: bool = False


def events(prof) -> list[Event]:
    """The raw events of a stopped ``torch.profiler.profile``; a list of
    ``Event`` is passed through."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return list(prof)
    out = []
    for k in raw.events():
        start = k.start_ns() / 1e3
        end = (k.end_ns() if hasattr(k, "end_ns")
               else k.start_ns() + k.duration_ns()) / 1e3
        note = getattr(k, "is_user_annotation", None)
        out.append(Event(k.name(), k.device_type().name, k.start_thread_id(),
                         start, end, k.correlation_id(),
                         k.linked_correlation_id(),
                         k.is_async() or k.start_thread_id() !=
                         k.end_thread_id(), bool(note and note())))
    return out


def _is_range(e: Event) -> bool:
    """A host range's device-side copy (``gpu_user_annotation``)."""
    return e.annotation or e.name.startswith((PREFIX, BENCH_PREFIX))


def _segments(spans) -> list[tuple[float, float, str]]:
    """[(start, end, name)], sorted and disjoint, over which the innermost
    of ``spans`` ((start, end, name), nested: one thread's) is ``name``."""
    out, stack, t = [], [], 0.0
    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        while stack and stack[-1][0] <= s:
            end, inner = stack.pop()
            out.append((t, end, inner))
            t = end
        if stack:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, inner = stack.pop()
        out.append((t, end, inner))
        t = end
    return [seg for seg in out if seg[1] > seg[0]]


class _Timeline:
    """The innermost program span over time, on one thread."""

    def __init__(self, spans):
        self.segs = _segments(spans)
        self.starts = [s for s, _, _ in self.segs]

    def at(self, t: float) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None

    def overlap(self, a: float, b: float) -> dict[str, float]:
        """{name: time} of [a, b] under each innermost span."""
        out: dict[str, float] = {}
        for s, e, name in self.segs[max(bisect.bisect_right(
                self.starts, a) - 1, 0):]:
            if s >= b:
                break
            d = min(e, b) - max(s, a)
            if d > 0:
                out[name] = out.get(name, 0.0) + d
        return out


def thread_of(prof, name: str):
    """The profiler's id of the thread on which the first host range named
    ``name`` opened (None where there is none)."""
    first = min((e for e in events(prof) if e.name == name
                 and e.kind == "CPU"), key=lambda e: e.start, default=None)
    return None if first is None else first.thread


def program_summary(prof, main_thread) -> dict:
    """``prof``: a stopped ``torch.profiler.profile`` (or its ``events``);
    ``main_thread``: the profiler's id of the thread that runs the loop.
    -> {"spans": {name: {"calls", "host_s", "device_s"}} (each program span
    by its name without the prefix; device seconds of the operations put
    down to it), "idle_by_span": {name or "outside": seconds},
    "device_s" (every device operation), "outside_s" (linked to a launch
    under no program span), "unlinked_s" (linked to no host call),
    "busy_s"}."""
    spans: dict[str, list] = {}
    by_thread: dict[int, list] = {}
    hosts, calls = {}, {}
    ops = []
    for e in events(prof):
        if e.kind != "CPU":
            if not _is_range(e):
                ops.append(e)
            continue
        start, end = e.start, e.end
        if e.name.startswith(PREFIX):
            name = e.name[len(PREFIX):]
            rec = spans.setdefault(name, [0, 0.0, 0.0])
            rec[0] += 1
            rec[1] += end - start
            by_thread.setdefault(e.thread, []).append((start, end, name))
        if e.name.startswith(API):
            calls[e.id] = e
        elif not e.linked and not e.is_async:
            hosts[e.id] = e
    lines = {t: _Timeline(s) for t, s in by_thread.items()}
    main = lines.get(main_thread)
    device = outside = unlinked = 0.0
    for d in ops:
        dur = d.end - d.start
        device += dur
        host = hosts.get(d.linked) if d.linked else None
        host = host or calls.get(d.id)
        if host is None:
            unlinked += dur
            continue
        if host.name.startswith(PREFIX):
            name = host.name[len(PREFIX):]
        else:
            t = (host.start + host.end) / 2
            line = lines.get(host.thread)
            name = line.at(t) if line else None
            if name is None and main is not None and \
                    host.thread != main_thread:
                name = main.at(t)
        if name is None:
            outside += dur
        else:
            spans[name][2] += dur
    busy = _union([(d.start, d.end) for d in ops])
    idle: dict[str, float] = {}
    for (_, a), (b, _) in zip(busy, busy[1:]):
        left = b - a
        for name, us in (main.overlap(a, b) if main else {}).items():
            idle[name] = idle.get(name, 0.0) + us / 1e6
            left -= us
        idle["outside"] = idle.get("outside", 0.0) + left / 1e6
    return {
        "spans": {k: {"calls": v[0], "host_s": v[1] / 1e6,
                      "device_s": v[2] / 1e6} for k, v in spans.items()},
        "idle_by_span": idle,
        "device_s": device / 1e6,
        "outside_s": outside / 1e6,
        "unlinked_s": unlinked / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
    }


def _units(ctx: dict, per: str):
    """The traced steps (``per="steps"``) or B-scans (``"bscans"``)."""
    if per == "steps":
        return ctx.get("traced_steps") or None
    return sum(ctx.get("profiled_batches") or ()) or None


def span_device_ms(ctx: dict, names, per: str):
    """Device ms put down to the program spans ``names``, a traced step or
    B-scan; None where the run holds no program summary or none of the
    spans ran."""
    program, units = ctx.get("program"), _units(ctx, per)
    if not program or not units:
        return None
    found = [program["spans"][n] for n in names if n in program["spans"]]
    if not found:
        return None
    return 1e3 * sum(s["device_s"] for s in found) / units


def idle_ms(ctx: dict, keep, per: str):
    """Device idle ms under the program spans whose names ``keep(name)``
    accepts, a traced step or B-scan; None where there is no program
    summary or no such span ran."""
    program, units = ctx.get("program"), _units(ctx, per)
    if not program or not units or not any(map(keep, program["spans"])):
        return None
    return 1e3 * sum(s for n, s in program["idle_by_span"].items()
                     if n != "outside" and keep(n)) / units


def counter(ctx: dict, name: str):
    """The program's counter ``name`` over the traced window (None where
    the run kept no counters or the program never counted it)."""
    return (ctx.get("counters") or {}).get(name)
