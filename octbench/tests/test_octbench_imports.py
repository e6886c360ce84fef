"""No module that a cell runs is JAX or the JAX package, and the plain
reference imports nothing of the program.

Each check runs in a fresh interpreter, so that what the test process has
loaded does not count. Module names are compared by their whole top-level
name: the program's name begins with the JAX package's.
"""

from __future__ import annotations

import ast
import importlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from octbench import harness, run

REPO = harness.REPO


def _loaded_after(code: str) -> list[str]:
    """Top-level names of the modules loaded after running ``code``."""
    probe = code + (
        "\nimport sys, json\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_no_cell_loads_jax():
    """Everything each cell's run loads: the runner, each configuration,
    traffic mix and driver, the per-layer readers, the reference and the
    program's modules that the drivers call."""
    code = f"""
import importlib
from octbench import harness, run
from octbench.reference import common, relaynet, train, unet
bench = harness.benchmark()
for c in bench["configs"]:
    harness.reference(harness.config(bench, c["name"]))
for wl in bench["workloads"]:
    harness.config(bench, wl["config"])
    mix = harness.traffic(wl["traffic"])
    importlib.import_module("octbench.drivers." + mix["driver"])
    harness.limits(wl["name"])
    for m in harness.per_layer_metrics(bench, wl):
        harness.reader(m["name"])
for mod in ("cli", "ops._build", "training.data", "training.input_pipeline",
            "training.packed_unet", "parallel.launch", "parallel.sharding"):
    importlib.import_module("{harness.PROGRAM}." + mod)
"""
    loaded = _loaded_after(code)
    assert harness.PROGRAM in loaded  # the program itself was loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


def test_reference_loads_no_program():
    loaded = _loaded_after(
        "from octbench.reference import common, relaynet, train, unet")
    assert not set(loaded) & {harness.PROGRAM, *harness.FORBIDDEN}


@pytest.mark.parametrize("path", sorted(
    (REPO / "octbench" / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_sources_import_no_program(path):
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    tops = {n.split(".")[0] for n in names}
    assert not tops & {harness.PROGRAM, *harness.FORBIDDEN, "octbench"}


def _run(cwd: Path) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-m", "octbench.run", "--workload",
         "unet_f32.bulk_volumes", "--seed", "3000000007", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300)


def test_benchmark_alone_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's own
    files the run fails and prints no result line."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    for p in json.loads((REPO / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(REPO / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    done = _run(tmp_path)
    assert done.returncode != 0
    assert '"correct"' not in done.stdout


def test_no_card_prints_no_result():
    """Where torch sees no card (as in this test run) the run fails and
    prints no result line."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    done = _run(REPO)
    assert done.returncode != 0
    assert done.stdout.strip() == ""


class _ImportsJax:
    """Unpickled in a rank that a driver started, it imports a module
    named ``jax`` there (and nowhere else)."""

    def __reduce__(self):
        return importlib.import_module, ("jax",)


def test_a_rank_holding_jax_refuses_the_run(tmp_path, monkeypatch):
    """Two gloo ranks of the data-parallel cell, each of which imports a
    stand-in named ``jax`` with its job: the run refuses, naming it,
    though the process that prints the result holds no JAX module."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('"""A stand-in named jax."""\n')
    monkeypatch.syspath_prepend(str(stub.parent))
    bench = harness.benchmark()
    wl = harness.workload(bench, "unet_f32.train_dp4_b32")
    cfg = dict(harness.config(bench, wl["config"]), image_size=64)
    mix = dict(harness.traffic(wl["traffic"]), chips=2, batch_per_chip=2,
               rows=8, trace_seconds=0.2, marker=_ImportsJax())
    with pytest.raises(harness.ForbiddenModules, match="jax"):
        run.execute(bench, wl, cfg, mix, 2 ** 31 + 3, 0.0, False,
                    device="cpu")
    assert "jax" not in sys.modules
