"""The benchmark of the PyTorch and CUDA port on NVIDIA H100 cards.

    python3 -m octbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` from the root of a checkout: its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``, run by ``drivers/<driver>.py``), and with
``--trace 1`` its per-layer metrics (``metrics/<name>.py``). The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``; last, ``checks``: each compared number with its limit); the
last lines of standard error are the same numbers, one a line.

Exits with a code other than 0, and prints no result, where the cell
needs more cards than ``torch.cuda`` sees, or where a JAX module is loaded
once the window has closed: in this process, or in any rank that the
cell's driver started.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The ``perf_counter`` reading at this process's start: its age from
    ``/proc/self/stat`` (ticks since boot), or now where that is missing."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return now - (boot - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


STARTED = _process_start()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="octbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _fail(msg: str, code: int = 3) -> int:
    print(f"octbench: {msg}", file=sys.stderr)
    return code


def execute(bench: dict, wl: dict, cfg: dict, mix: dict, seed: int,
            seconds: float, trace: bool, device: str = "cuda",
            fault: str | None = None, control: str | None = None,
            limits: dict | None = None) -> dict:
    """Run the cell and check it; -> the result line (a dict). ``fault``
    and ``control`` break the timed path on purpose (the checks of the
    check); ``limits`` default to the cell's ``limits/`` file. Raises
    ``harness.ForbiddenModules`` where a rank that the driver started
    held a JAX module after its window."""
    import torch

    driver = importlib.import_module(f"octbench.drivers.{mix['driver']}")
    res = driver.run(cfg, mix, seed, seconds, trace, device=device,
                     limits=limits or harness.limits(wl["name"]),
                     fault=fault, control=control, started=STARTED)
    if res.get("rank_modules"):
        raise harness.ForbiddenModules(", ".join(res["rank_modules"]))
    if trace:
        metrics = {}
        for m in harness.per_layer_metrics(bench, wl):
            value = harness.reader(m["name"])(res["ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": res["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in harness.end_to_end_metrics(bench, wl)}
    bad = [k for k, v in metrics.items() if not math.isfinite(v["value"])]
    if bad:
        raise RuntimeError(f"metrics not finite: {bad}")
    cuda = device == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": wl["chips"],
            "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": harness.checks_passed(res["checks"]),
            "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": info}
    if trace and res["trace"]:
        busy = res["busy"]
        info["busy_s"] = sum(busy) / len(busy)
        info["window_s"] = res["trace"]["window_s"]
        line["breakdown"] = {"device_ops": res["trace"]["device_ops"],
                             "idle_gaps": res["trace"]["idle_gaps"]}
        calls = {k: v[1] for k, v in sorted(
            res["trace"]["ops"].items(), key=lambda kv: -kv[1][0])[:20]}
        print(f"octbench: traced calls by device operation: "
              f"{json.dumps(calls)}", file=sys.stderr)
    print(f"octbench: set-up phases (s): "
          f"{json.dumps(res['ctx'].get('setup_phases'))}; the reference "
          f"{res['ctx'].get('reference_s')} s", file=sys.stderr)
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.benchmark()
    wl = harness.workload(bench, args.workload)
    cfg = harness.config(bench, wl["config"])
    mix = harness.traffic(wl["traffic"])

    import torch

    if not torch.cuda.is_available():
        return _fail("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < wl["chips"]:
        return _fail(f"{wl['name']} needs {wl['chips']} cards, "
                     f"{torch.cuda.device_count()} seen")
    if mix.get("chips", 1) != wl["chips"]:
        return _fail(f"traffic {wl['traffic']} runs on {mix['chips']} "
                     f"cards, the workload asks for {wl['chips']}")
    # the program's kernels: built here once (the first run of a checkout)
    build = importlib.import_module(f"{harness.PROGRAM}.ops._build")
    build.build()

    try:
        line = execute(bench, wl, cfg, mix, args.seed, args.seconds,
                       bool(args.trace))
    except harness.ForbiddenModules as e:
        return _fail(f"JAX modules loaded in a rank of the run: {e}")
    found = harness.forbidden_modules()
    if found:
        return _fail("JAX modules loaded in this process: "
                     + ", ".join(found))
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
