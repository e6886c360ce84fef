"""The port's tracing (``utils/profiling``) on the CPU: ``annotate`` is a
shared no-op while tracing is off and a nested profiler range carrying its
id while on; the counters; and the spans and counters at the layer
boundaries: the packed train step's phases and rows, the input pipeline's
copy, transform and wait, the collectives on a 2-rank gloo group, the
served graph's preprocessing and unpools, and ``ServingLoop``'s queue wait
and batch fill on ``/healthz``."""

import json
import sys
import threading
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
    OptimConfig,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
    start_in_background,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
    unet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.relaynet_psrp import (
    relaynet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.server import (
    ServingLoop,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    UNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel import (
    collectives,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.launch import (
    run_ranks,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    losses,
    packed_unet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.input_pipeline import (
    DevicePrefetcher,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
    create_train_state,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils import (
    profiling,
)

PREFIX = profiling.PREFIX


def _spans(prof):
    """[(name without the prefix, id or None, profiler event)] of the
    program's spans, in the order they opened."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith(PREFIX) and e.device_type.name == "CPU":
            ids = [v for v in (e.concrete_inputs or []) if v is not None]
            out.append((e.name[len(PREFIX):], ids[0] if ids else None, e))
    return out


def _traced(fn):
    """``fn()`` with tracing on under a CPU profiler that records inputs;
    -> (its result, the spans, the counters it made)."""
    profiling.reset_counters()
    with profiling.tracing(), profile(
            activities=[ProfilerActivity.CPU], record_shapes=True,
            experimental_config=profiling.all_threads()) as prof:
        out = fn()
    counts = profiling.counters()
    profiling.reset_counters()
    return out, _spans(prof), counts


def test_annotate_off_makes_no_profiler_call():
    calls = []
    note = lambda *a, **k: calls.append(a)  # noqa: E731
    with mock.patch.object(torch.autograd, "_record_function_with_args_enter",
                           note), \
            mock.patch.object(torch.profiler, "record_function", note), \
            mock.patch.object(torch.cuda.nvtx, "range_push", note):
        first = profiling.annotate("a", 3)
        with first:
            with profiling.annotate("b") as inner:
                assert inner is None
        assert profiling.annotate("c") is first  # one shared no-op
        assert calls == []
        with profiling.tracing():
            span = profiling.annotate("a", 3)
        assert span is not first
    assert not profiling._on


def test_annotate_on_nests_and_carries_its_id(tmp_path):
    def body():
        with profiling.annotate("outer", 7):
            with profiling.annotate("inner"):
                torch.ones(4) + 1
            with profiling.annotate("inner", 8):
                pass

    _, spans, _ = _traced(body)
    assert [(n, i) for n, i, _ in spans] == [("outer", 7), ("inner", None),
                                             ("inner", 8)]
    assert all(e.cpu_parent is spans[0][2] for _, _, e in spans[1:])
    with profiling.trace(str(tmp_path)):
        body()
    (path,) = tmp_path.iterdir()
    names = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
             if e.get("name", "").startswith(PREFIX)}
    assert set(names) == {PREFIX + "outer", PREFIX + "inner"}
    assert names[PREFIX + "outer"]["args"]["Concrete Inputs"] == ["7"]
    assert not profiling._on  # the trace's switch is restored


@pytest.mark.parametrize("case", ["off", "on", "two threads"])
def test_counters(case):
    profiling.reset_counters()
    n = 2000
    if case == "off":
        profiling.count("x", 5)
        assert profiling.counters() == {}
        return
    with profiling.tracing():
        if case == "on":
            profiling.count("x", 5)
            profiling.count("x")
            profiling.count("y", 0)
            got = profiling.counters()
            got["x"] = -1  # a copy
            assert profiling.counters() == {"x": 6, "y": 0}
        else:
            switch = sys.getswitchinterval()
            sys.setswitchinterval(1e-6)
            try:
                threads = [threading.Thread(
                    target=lambda: [profiling.count("x") for _ in range(n)])
                    for _ in range(2)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
            finally:
                sys.setswitchinterval(switch)
            assert profiling.counters() == {"x": 2 * n}
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_packed_step_opens_its_phases_and_counts_rows():
    model = UNet(1, 5, 4, generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, OptimConfig())
    step = packed_unet.make_packed_train_step(losses.dice_ce_loss)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((3, 32, 32, 1)), dtype=torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 5, (3, 32, 32)))
    step(state, x, y)  # step 0, untraced
    _, spans, counts = _traced(lambda: step(state, x, y))
    assert [(n, i) for n, i, _ in spans] == [
        ("step.forward", 1), ("step.loss", 1), ("step.backward", 1),
        ("step.update", 1)]
    assert counts == {"input.rows_used": 3}


def test_prefetcher_spans_share_batch_ids_and_count_copies():
    """Three batches moved to the meta device (a real move, on the CPU),
    with a transform: copy, prepare and wait of batch k carry id k; the
    rows and bytes moved are counted as each batch is taken."""
    batches = [(torch.zeros(2 + k, 4, 4), torch.zeros(2 + k, 4, 4,
                                                      dtype=torch.int64))
               for k in range(3)]
    got, spans, counts = _traced(lambda: list(DevicePrefetcher(
        batches, "meta", transform=lambda b: (b[0] * 2, b[1]))))
    assert [b[0].device.type for b in got] == ["meta"] * 3
    ids = {name: [i for n, i, _ in spans if n == name]
           for name in ("input.copy", "input.prepare", "input.wait")}
    assert ids["input.copy"] == ids["input.prepare"] == [0, 1, 2]
    assert ids["input.wait"] == [0, 1, 2, 3]  # the fourth meets the end
    rows = sum(2 + k for k in range(3))
    assert counts == {"input.rows_copied": rows,
                      "input.bytes_copied": rows * 16 * (4 + 8)}


def _collective_counts():
    """Each collective once on this rank, under tracing -> {name: (calls,
    bytes)} it counted."""
    group = torch.distributed.group.WORLD
    rank = torch.distributed.get_rank()
    calls = {
        "all_reduce_sum": lambda: collectives.all_reduce_sum(
            torch.ones(5), group),
        "all_gather_cat": lambda: collectives.all_gather_cat(
            torch.ones(3, dtype=torch.float64), group),
        "broadcast": lambda: collectives.broadcast(
            torch.ones(4, dtype=torch.int64), 0, group),
        "exchange": lambda: collectives.exchange(
            torch.ones(2, 3) if rank else None,
            None if rank else torch.ones(2, 3), rank - 1 if rank else None,
            None if rank else 1, group),
    }
    out = {}
    for name, call in calls.items():
        profiling.reset_counters()
        with profiling.tracing():
            call()
        c = profiling.counters()
        out[name] = (c.get("collective.calls"), c.get("collective.bytes"))
    return out


@pytest.fixture(scope="module")
def collective_counts():
    return run_ranks(_collective_counts, 2, backend="gloo", timeout=300)


@pytest.mark.parametrize("name,nbytes", [("all_reduce_sum", 20),
                                         ("all_gather_cat", 24),
                                         ("broadcast", 32), ("exchange", 24)])
def test_collectives_count_calls_and_bytes(collective_counts, name, nbytes):
    assert [r[name] for r in collective_counts] == [(1, nbytes)] * 2


@pytest.mark.parametrize("model,graph,unpools", [
    ("unet", unet_psrp_forward, 0), ("relaynet", relaynet_psrp_forward, 3)])
def test_served_graph_spans(model, graph, unpools):
    """The reference forward opens ``serve.preprocess`` (and ReLayNet's
    ``serve.unpool`` three times); the served forward of
    ``build_quantized_forward`` is ``serve.forward`` with the call's number,
    around the z-score and the graph's own spans."""
    net = cli.build_model(model, num_classes=4, init_features=4, seed=0,
                          device="cpu")
    forward, calib = cli.build_quantized_forward(net, model, "psrp",
                                                 image_size=32, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 255, (1, 32, 32, 1)).astype(np.float32))
    want = ["serve.preprocess"] + ["serve.unpool"] * unpools
    _, spans, _ = _traced(lambda: graph(calib["qparams"], x, 4,
                                        reference=True))
    assert [n for n, _, _ in spans] == want
    forward(x)  # call 0, untraced
    _, spans, _ = _traced(lambda: forward(x))
    assert [(n, i) for n, i, _ in spans[:2]] == [("serve.forward", 1),
                                                 ("serve.preprocess", None)]
    assert [n for n, _, _ in spans[2:]] == want
    assert all(e.cpu_parent is spans[0][2] for _, _, e in spans[1:3])


def test_serving_loop_queue_wait_and_fill_on_healthz():
    loop = ServingLoop(lambda x: x[..., 0].to(torch.int8), (4, 4, 1),
                       device="cpu", batch_size=4, max_wait_ms=50.0)
    futs = [loop.submit(np.full((4, 4, 1), i, np.float32)) for i in range(6)]
    httpd, _ = start_in_background(loop, port=0)
    try:
        for i, f in enumerate(futs):
            assert f.result(timeout=60)[0, 0] == i
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=30) as r:
            h = json.loads(r.read())
    finally:
        httpd.shutdown()
        loop.close()
    # queued before the loop started: batches of 4 and 2
    assert (h["batches_run"], h["batch_fill"], h["requests_served"]) == \
        (2, 6, 6)
    assert h["queue_wait_s"] > 0.0
    assert h["queue_wait_s"] == loop.queue_wait_s
