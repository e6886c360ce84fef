"""Readings of the correctness check for its limits: sound runs of the
program, the control (the lower precision put in the program's place) and
the faults planted in the timed path, each on several seeds, at the
cell's own size and load, on the card.

    python3 -m octbench.control --workload <name> \\
        --plan "sound=1,2,3;control:fp8=4,5;fault:half_batch=4,5" \\
        [--seconds 1]

runs each mode of the plan (``sound``, ``control:<name>`` or
``fault:<name>``) on its seeds, all in one process (one process group for
a cell on several cards), and prints one JSON line a run: the numbers
compared, the readings and leaves they came from, and the reference's
seconds. The benchmark's runs never run this.
A short window suffices: the check compares what set-up and the first
volumes or steps produced.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402

from . import harness  # noqa: E402


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="octbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--plan", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    bench = harness.benchmark()
    wl = harness.workload(bench, args.workload)
    cfg = harness.config(bench, wl["config"])
    mix = harness.traffic(wl["traffic"])
    jobs = []
    for part in args.plan.split(";"):
        mode, _, seeds = part.partition("=")
        kind, _, name = mode.partition(":")
        if kind not in ("sound", "control", "fault"):
            raise SystemExit(f"--plan: unknown mode {mode!r}")
        for seed in seeds.split(","):
            job = dict(seed=int(seed), control=None, fault=None)
            if name:
                job[kind] = name
            jobs.append(job)
    driver = importlib.import_module(f"octbench.drivers.{mix['driver']}")
    if hasattr(driver, "run_jobs"):
        ranks = driver.run_jobs(
            cfg, mix, [dict(j, seconds=args.seconds, trace=False)
                       for j in jobs], args.device, STARTED)
        results = [driver.result(cfg, mix, r, None) for r in ranks]
    else:
        results = [driver.run(cfg, mix, j["seed"], args.seconds, False,
                              device=args.device, fault=j["fault"],
                              control=j["control"]) for j in jobs]
    for job, res in zip(jobs, results):
        ctx = res["ctx"]
        line = {"workload": wl["name"], **job,
                "checks": {k: v["value"] for k, v in res["checks"].items()},
                "reference_s": ctx.get("reference_s")}
        if "readings" in ctx:
            line["readings"] = ctx["readings"]
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
