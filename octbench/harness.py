"""What the runner and the drivers share: the benchmark's files found by
name (configurations, their reference modules, traffic mixes, limits and
per-layer readers), and the check that no JAX module is loaded."""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# top-level module names that no process of a run may hold
FORBIDDEN = ("jax", "jaxlib", "flax",
             "retinal_oct_image_segmentation_via_deep_learning_tpu")
# the program under test
PROGRAM = "retinal_oct_image_segmentation_via_deep_learning_tpu_torch"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(REPO / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(REPO / c["file"])
    raise SystemExit(f"no configuration {name!r} in BENCHMARK.json")


def reference(cfg: dict):
    """The plain reference module that configuration ``cfg`` names
    (``"reference": "octbench/reference/<model>.py"``). It supplies
    ``param_spec(cfg)`` and ``forward_ops(cfg)``, and for the cells that
    use them ``prepare_int8``/``int8_labels`` (serving) and
    ``train_steps``/``STEM`` (training)."""
    path = Path(cfg["reference"])
    if path.suffix != ".py" or path.parts[0] != ROOT.name or \
            ".." in path.parts or not (REPO / path).is_file():
        raise SystemExit(f"configuration {cfg.get('name')!r}: no reference "
                         f"module at {cfg['reference']!r}")
    return importlib.import_module(".".join(path.with_suffix("").parts))


def traffic(name: str) -> dict:
    return load_json(ROOT / "traffic" / f"{name}.json")


def limits(workload_name: str) -> dict:
    """The limits of the workload's correctness check (``limits/``)."""
    return load_json(ROOT / "limits" / f"{workload_name}.json")


def reader(metric_name: str):
    """The ``read(ctx)`` function of ``metrics/<name>.py``."""
    path = ROOT / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        f"octbench_metric_{metric_name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def per_layer_metrics(bench: dict, wl: dict) -> list[dict]:
    """The per-layer metrics a traced run of ``wl`` reports: those whose
    ``workloads`` list it (every per-layer metric lists its cells)."""
    for m in bench["per_layer"]:
        if "workloads" not in m:
            raise SystemExit(f"per-layer metric {m['name']!r} lists no "
                             f"workloads")
    return [m for m in bench["per_layer"] if wl["name"] in m["workloads"]]


def end_to_end_metrics(bench: dict, wl: dict) -> list[dict]:
    return [m for m in bench["end_to_end"]
            if wl["name"] in m.get("workloads", [wl["name"]])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


class ForbiddenModules(RuntimeError):
    """A process of the run (a rank that a driver started) held JAX
    modules once its window had closed."""


def checks_passed(checks: dict) -> bool:
    """Whether every compared number is within its limit."""
    return all(v["value"] <= v["limit"] for v in checks.values())
