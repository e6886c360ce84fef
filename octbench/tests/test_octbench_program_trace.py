"""``program_trace.program_summary`` on a synthetic profiler event list,
and the readers of the program's spans and counters: each reads its
number from a traced run's ``ctx["program"]`` / ``ctx["counters"]``, and
returns None where the run was not traced or the program has no such span
or counter."""

from __future__ import annotations

import pytest

from octbench import harness
from octbench.program_trace import Event, program_summary, thread_of

MAIN, ENGINE = 1, 2


def _ev(name, start, end, *, kind="CPU", thread=MAIN, id=0, linked=0,
        annotation=False):
    return Event(name, kind, thread, start, end, id, linked,
                 annotation=annotation)


def _events():
    """Times in us. A forward span with an op's kernel and a kernel its
    span launched itself; a backward span whose kernel the engine thread
    launched with no span of its own open; an update span with a nested
    span; a memset linked to no host call; a kernel launched under no
    program span; a kernel linked to no operation but to the CUDA call
    that launched it (a ``ctypes`` kernel), whose id an operation's shares
    (ids of operations and of CUDA calls are counted apart)."""
    return [
        _ev("octbench: step", 0, 600, id=90),
        _ev("octseg: step.forward", 0, 100, id=1),
        _ev("aten::conv", 10, 20, id=2),
        _ev("kernel_a", 15, 40, kind="CUDA", id=1002, linked=2),
        _ev("kernel_direct", 50, 60, kind="CUDA", id=1001, linked=1),
        _ev("octseg: step.forward", 0, 100, kind="CUDA", annotation=True),
        _ev("octseg: step.backward", 100, 300, id=3),
        _ev("autograd::engine::evaluate_function", 150, 160, thread=ENGINE,
            id=4),
        _ev("kernel_b", 155, 200, kind="CUDA", id=1004, linked=4),
        _ev("octseg: step.update", 300, 400, id=5),
        _ev("aten::add_", 310, 320, id=6),
        _ev("octseg: step.inner", 340, 360, id=8),
        _ev("kernel_c", 350, 380, kind="CUDA", id=1006, linked=6),
        _ev("Memset (Device)", 390, 395, kind="CUDA", id=1009),
        _ev("aten::item", 490, 495, id=7),
        _ev("kernel_d", 500, 510, kind="CUDA", id=1007, linked=7),
        _ev("octseg: step.update", 600, 700, id=10),
        _ev("aten::mul", 605, 606, id=5000),
        _ev("cudaLaunchKernel", 610, 612, thread=12345, id=5000),
        _ev("kernel_ctypes", 620, 640, kind="CUDA", id=5000),
    ]


def test_program_summary_on_synthetic_events():
    got = program_summary(_events(), MAIN)
    us = 1e-6
    want_device = {"step.forward": 35, "step.backward": 45,
                   "step.update": 30 + 20, "step.inner": 0}
    want_host = {"step.forward": 100, "step.backward": 200,
                 "step.update": 200, "step.inner": 20}
    assert set(got["spans"]) == set(want_device)
    for name, s in got["spans"].items():
        assert s["calls"] == (2 if name == "step.update" else 1)
        assert s["device_s"] == pytest.approx(want_device[name] * us)
        assert s["host_s"] == pytest.approx(want_host[name] * us)
    # gaps: [40, 50] and [60, 155] split between forward and backward;
    # [200, 350] over backward, update and its nested span; [395, 500]
    # partly outside every program span; [510, 620] likewise
    want_idle = {"step.forward": 50, "step.backward": 155,
                 "step.update": 55 + 20, "step.inner": 10,
                 "outside": 100 + 90}
    assert got["idle_by_span"] == pytest.approx(
        {k: v * us for k, v in want_idle.items()})
    assert got["device_s"] == pytest.approx(145 * us)
    assert got["busy_s"] == pytest.approx(145 * us)
    assert got["outside_s"] == pytest.approx(10 * us)   # kernel_d
    assert got["unlinked_s"] == pytest.approx(5 * us)   # the memset


def test_launch_off_every_span_without_a_main_thread_is_outside():
    """Without the main thread's spans, the engine thread's launch has no
    span to go to; every gap is outside."""
    got = program_summary(_events(), main_thread=99)
    assert got["spans"]["step.backward"]["device_s"] == 0.0
    assert got["outside_s"] == pytest.approx(75e-6)
    assert set(got["idle_by_span"]) == {"outside"}


def test_thread_of():
    assert thread_of(_events(), "octbench: step") == MAIN
    assert thread_of(_events(), "autograd::engine::evaluate_function") == \
        ENGINE
    assert thread_of(_events(), "no such range") is None


PROGRAM = {
    "spans": {n: {"calls": 2, "host_s": 0.1, "device_s": d} for n, d in (
        ("serve.preprocess", 0.002), ("serve.unpool", 0.02),
        ("step.forward", 0.01), ("step.loss", 0.002),
        ("step.backward", 0.02), ("step.update", 0.005),
        ("input.wait", 0.0))},
    "idle_by_span": {"step.forward": 0.001, "step.backward": 0.002,
                     "input.wait": 0.004, "outside": 0.5},
    "device_s": 0.06, "outside_s": 0.0, "unlinked_s": 0.0, "busy_s": 0.06,
}
COUNTERS = {"input.rows_used": 64, "input.rows_copied": 256,
            "collective.calls": 82, "collective.bytes": int(59.4 * 2 ** 20)}
READINGS = {
    "preprocess_ms_per_bscan.serve": 0.02,
    "unpool_ms_per_bscan.serve": 0.2,
    "forward_ms_per_step.train": 6.0,
    "backward_ms_per_step.train": 10.0,
    "update_ms_per_step.train": 2.5,
    "dispatch_idle_ms_per_step.train": 1.5,
    "input_idle_ms_per_step.train": 2.0,
    "input_used_share.train": 25.0,
    "exchange_calls_per_step.train": 41.0,
    "exchange_mib_per_step.train": 29.7,
}
EMPTY = {"spans": {}, "idle_by_span": {"outside": 0.1}, "device_s": 0.1,
         "outside_s": 0.1, "unlinked_s": 0.0, "busy_s": 0.1}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader(name):
    read = harness.reader(name)
    traced = {"traced_steps": 2, "profiled_batches": [49, 51]}
    assert read(dict(traced, program=PROGRAM, counters=COUNTERS)) == \
        pytest.approx(READINGS[name], rel=1e-6)
    # not traced; traced on a program without the spans or counters
    assert read({"traced_steps": None, "profiled_batches": []}) is None
    assert read(dict(traced)) is None
    assert read(dict(traced, program=EMPTY, counters={})) is None


def test_program_summary_reads_a_profiler_run():
    """A CPU profiler run of the program's spans, one of them on a second
    thread: read from the profiler's raw events, each span's calls and
    host time; nothing ran on a card."""
    import importlib
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    profiling = importlib.import_module(f"{harness.PROGRAM}.utils.profiling")

    def side():
        with profiling.annotate("side"):
            torch.ones(8) * 2

    with profiling.tracing(), profile(
            activities=[ProfilerActivity.CPU],
            experimental_config=profiling.all_threads()) as prof:
        with profiling.annotate("outer", 1):
            for _ in range(3):
                with profiling.annotate("inner"):
                    torch.ones(8) + 1
        t = threading.Thread(target=side)
        t.start()
        t.join(timeout=60)
    got = program_summary(prof, thread_of(prof, "octseg: outer"))
    assert {k: v["calls"] for k, v in got["spans"].items()} == \
        {"outer": 1, "inner": 3, "side": 1}
    assert got["spans"]["outer"]["host_s"] >= \
        got["spans"]["inner"]["host_s"] > 0
    assert got["device_s"] == got["busy_s"] == 0.0
    assert got["idle_by_span"] == {}
    assert thread_of(prof, "octseg: side") != thread_of(prof, "octseg: outer")
