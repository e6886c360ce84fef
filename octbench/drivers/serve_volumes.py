"""Bulk serving of OCT volumes through the program's served int8 graph.

A closed loop with one volume in flight, as a reading centre segments an
archive: copy the volume's uint8 B-scans to the card, ``forward(images)``
from the program's ``cli.build_quantized_forward``, copy the int8 labels
back to the host. Volume sizes come in blocks that hold each of the
traffic's sizes once, in an order drawn from the seed, so every seed does
the same work; each volume is a run of B-scans of a pool made from the
seed at set-up. The window ends with the first block done after
``seconds``.

Correctness: one volume of each size, drawn from the seed among those
completed in the window (a reservoir of one a size, decided before the
volume is copied back, so its labels land in a buffer of their own), is
segmented again by the plain reference's int8 graph from the same weights
and calibration batch after the window; the share of labels that differ
is compared with its limit.
"""

from __future__ import annotations

import time

import numpy as np

from .. import data, harness, weights
from ..harness import PROGRAM
from ..trace import Spans, summarize

# traffic keys: "volume_sizes", "pool_bscans", "grey_gain", "trace_seconds"


def _schedule(rng: np.random.Generator, sizes: list[int], pool: int):
    """Endless (B-scans, first B-scan in the pool) of each volume."""
    while True:
        for n in rng.permutation(sizes):
            n = int(n)
            yield n, int(rng.integers(0, pool - n + 1))


def build(cfg: dict, seed: int, device, control: str | None = None):
    """The served forward of configuration ``cfg`` with weights from
    ``seed``, as the program's serve entry builds it. ``control``: the
    lower precision put in the program's place ("int4": the program's own
    w4a4 mode where it has one, else the reference at 4 bits)."""
    import importlib

    cli = importlib.import_module(f"{PROGRAM}.cli")
    serve = cfg["serve"]
    params = weights.make(cfg, seed, device)
    if control == "int4" and serve.get("int4_mode") is None:
        ref = harness.reference(cfg)
        q = ref.prepare_int8(params, cfg["image_size"], seed, device, lim=7)
        return lambda x: ref.int8_labels(q, x[..., 0], lim=7)
    # the serve entry's width option (each served model's own width)
    model = cli.build_model(cfg["model"], num_classes=cfg["num_classes"],
                            init_features=cfg["width"], seed=0,
                            device=device)
    missing, unexpected = model.load_state_dict(params, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise RuntimeError(f"weights do not fit the program's model: "
                           f"missing {missing}, unexpected {unexpected}")
    mode = serve["int4_mode"] if control == "int4" else serve["quantize"]
    forward, _ = cli.build_quantized_forward(
        model, cfg["model"], mode, image_size=cfg["image_size"],
        device=device, seed=seed)
    return forward


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device="cuda", limits: dict | None = None, fault: str | None = None,
        control: str | None = None, started: float | None = None) -> dict:
    """One run; -> the driver's result (see ``run.py``). ``fault``
    ("altered": every volume's first B-scan gets other labels) and
    ``control`` break the timed path on purpose, for the checks of the
    check."""
    import torch

    if fault not in (None, "altered") or control not in (None, "int4"):
        raise ValueError(f"fault {fault!r}, control {control!r}")
    started = time.perf_counter() if started is None else started
    dev = torch.device(device)
    side, nc = cfg["image_size"], cfg["num_classes"]
    sizes = [int(n) for n in traffic["volume_sizes"]]
    phases = {"imports": time.perf_counter() - started}
    t = time.perf_counter()
    forward = build(cfg, seed, dev, control)
    phases["weights and graph"] = time.perf_counter() - t
    t = time.perf_counter()
    pool, _ = data.make_rows(seed + 1, traffic["pool_bscans"], side, nc, dev,
                             grey_gain=traffic["grey_gain"], labels=False)
    phases["volume pool"] = time.perf_counter() - t
    out = np.empty((max(sizes), side, side), np.int8)
    kept_buf = {n: np.empty((n, side, side), np.int8) for n in sizes}
    spans = Spans()
    cuda = dev.type == "cuda"

    def serve_one(n, off, dst, events=None):
        with spans("copy in", trace):
            x = torch.from_numpy(pool[off:off + n]).to(dev)
        if events:
            events[0].record()
        with spans("forward", trace):
            labels = forward(x.unsqueeze(-1))
        if events:
            events[1].record()
        if fault == "altered":
            labels[0] = (labels[0] + 1) % nc
        with spans("copy out", trace):
            torch.from_numpy(dst[:n]).copy_(labels)

    # warm-up: every volume size once
    t = time.perf_counter()
    for n in sizes:
        serve_one(n, 0, out)
    if cuda:
        torch.cuda.synchronize(dev)
    phases["warm-up"] = time.perf_counter() - t
    spans = Spans()

    sched = _schedule(np.random.default_rng(seed), sizes, len(pool))
    keep_rng = np.random.default_rng([seed, 1])
    seen = {n: 0 for n in sizes}
    kept: dict[int, int] = {}
    latencies, fwd_events, profiled_n = [], [], []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    t_start = time.perf_counter()
    setup_s = t_start - started
    trace_s = None
    bscans = volumes = 0
    while True:
        n, off = next(sched)
        seen[n] += 1
        keep = keep_rng.random() < 1.0 / seen[n]
        events = ([torch.cuda.Event(enable_timing=True) for _ in range(2)]
                  if trace and cuda else None)
        t0 = time.perf_counter()
        serve_one(n, off, kept_buf[n] if keep else out, events)
        t1 = time.perf_counter()
        latencies.append(t1 - t0)
        if events:
            fwd_events.append(events)
        if keep:
            kept[n] = off
        bscans += n
        volumes += 1
        if prof is not None and trace_s is None:
            profiled_n.append(n)
            if t1 - t_start >= traffic["trace_seconds"]:
                prof.stop()
                trace_s = t1 - t_start
        # the window ends with a whole block of sizes, so that every run
        # serves the sizes alike and samples each
        if t1 - t_start >= seconds and volumes % len(sizes) == 0:
            break
    window_s = t1 - t_start
    if prof is not None and trace_s is None:
        prof.stop()
        trace_s = window_s
    fwd_ms = ([a.elapsed_time(b) for a, b in fwd_events]
              if fwd_events else None)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    summary = summarize(prof, trace_s) if prof is not None else None
    del forward
    if cuda:
        torch.cuda.empty_cache()

    # the reference, after the window, on the sampled volumes
    t_ref = time.perf_counter()
    ref = harness.reference(cfg)
    q = ref.prepare_int8(weights.make(cfg, seed, dev), side, seed, dev)
    differ = total = 0
    for n, off in sorted(kept.items()):
        images = torch.from_numpy(pool[off:off + n]).to(dev)
        want = ref.int8_labels(q, images).cpu().numpy()
        differ += int(np.count_nonzero(want != kept_buf[n][:n]))
        total += want.size
    reference_s = time.perf_counter() - t_ref
    missing = len(sizes) - len(kept)
    share = differ / total if total else 1.0
    lim = (limits or {}).get("label_mismatch_share", 0.0)
    checks = {"label_mismatch_share": {"value": share, "limit": lim},
              "sampled_sizes_missing": {"value": missing, "limit": 0}}
    lat = np.asarray(latencies)
    return {
        "end_to_end": {
            "serve_bscans_per_s": bscans / window_s,
            "serve_volume_p95_ms": float(np.percentile(lat, 95)) * 1e3,
            "setup_s": setup_s,
        },
        "ctx": {
            "cfg": cfg, "window_s": window_s, "bscans": bscans,
            "volumes": volumes, "latency_s": latencies,
            "forward_ms": fwd_ms, "trace": summary,
            "profiled_batches": profiled_n, "spans": spans.total,
            "chips": 1, "reference_s": reference_s, "setup_phases": phases,
        },
        "checks": checks,
        "attempted": volumes,
        "failed": 0,
        "memory_peak_bytes": memory_peak,
        "busy": [summary["busy_s"]] if summary else None,
        "trace": summary,
    }
