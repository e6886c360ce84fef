"""A later change adds a configuration with a reference module of its own,
a traffic mix and a per-layer metric as new files and new entries of
BENCHMARK.json alone: the harness finds them by name, runs them through
the new reference module, and reads the new metric, with no file of the
benchmark edited."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys

import pytest

from octbench import harness

DUMMY_METRIC = '''"""B-scans served per volume in the window (a dummy reader)."""


def read(ctx):
    if not ctx.get("volumes"):
        return None
    return ctx["bscans"] / ctx["volumes"]
'''

DUMMY_REFERENCE = '''"""A new configuration's plain reference (a test's): the U-Net's, under
a name of its own, noting what the harness asks of it."""

from . import unet

USED = set()


def _noted(name):
    def call(*args, **kwargs):
        USED.add(name)
        return getattr(unet, name)(*args, **kwargs)
    return call


param_spec = _noted("param_spec")
forward_ops = _noted("forward_ops")
prepare_int8 = _noted("prepare_int8")
int8_labels = _noted("int8_labels")
'''

PROBE = """
import json, sys
from octbench import harness, run
bench = harness.benchmark()
wl = harness.workload(bench, "unet_tiny.dummy_mix")
cfg = harness.config(bench, wl["config"])
mix = harness.traffic(wl["traffic"])
names = [m["name"] for m in harness.per_layer_metrics(bench, wl)]
line = run.execute(bench, wl, cfg, mix, 2 ** 32 + 9, 0.5, False,
                   device="cpu")
ctx_line = run.execute(bench, wl, cfg, mix, 2 ** 32 + 9, 0.5, True,
                       device="cpu")
used = sorted(sys.modules["octbench.reference.unet_tiny"].USED)
print(json.dumps({"names": names, "line": line, "traced": ctx_line,
                  "used": used}))
"""


def _digests(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "octbench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_and_entries_are_found(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(harness.REPO / "BENCHMARK.json", root)
    shutil.copytree(harness.REPO / "octbench", root / "octbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / harness.PROGRAM).symlink_to(harness.REPO / harness.PROGRAM)
    before = _digests(root)

    ob = root / "octbench"
    cfg = json.loads((ob / "configs" / "unet_f32.json").read_text())
    cfg.update(name="unet_tiny", width=8, image_size=64,
               reference="octbench/reference/unet_tiny.py")
    (ob / "reference" / "unet_tiny.py").write_text(DUMMY_REFERENCE)
    (ob / "configs" / "unet_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((ob / "traffic" / "bulk_volumes.json").read_text())
    mix.update(volume_sizes=[2, 3], pool_bscans=8, trace_seconds=0.2)
    (ob / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (ob / "limits" / "unet_tiny.dummy_mix.json").write_text(
        json.dumps({"label_mismatch_share": 0.0}))
    (ob / "metrics" / "bscans_per_volume.dummy.py").write_text(DUMMY_METRIC)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "unet_tiny", "source": "test",
                             "file": "octbench/configs/unet_tiny.json",
                             "reduced": ["width", "image_size"],
                             "why": "test"})
    bench["workloads"].append({"name": "unet_tiny.dummy_mix",
                               "config": "unet_tiny", "traffic": "dummy_mix",
                               "chips": 1, "why": "test"})
    bench["end_to_end"][0]["workloads"].append("unet_tiny.dummy_mix")
    bench["end_to_end"][1]["workloads"].append("unet_tiny.dummy_mix")
    for m in bench["per_layer"]:
        if m["name"] == "mfu.serve":
            m["workloads"].append("unet_tiny.dummy_mix")
    bench["per_layer"].append({
        "name": "bscans_per_volume.dummy", "unit": "B-scans",
        "better": "higher", "source": "program_counter", "layer": "serve entry",
        "moves": "serve_bscans_per_s", "workloads": ["unet_tiny.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    after = _digests(root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    done = subprocess.run([sys.executable, "-c", PROBE], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert "bscans_per_volume.dummy" in out["names"]
    assert out["line"]["correct"] is True
    assert set(out["line"]["metrics"]) == {"serve_bscans_per_s",
                                           "serve_volume_p95_ms", "setup_s"}
    value = out["traced"]["metrics"]["bscans_per_volume.dummy"]["value"]
    assert 2.0 <= value <= 3.0
    assert list(out["line"])[-1] == "checks"
    # the served forward's weights, the check and mfu.serve's work count
    # came from the new reference module
    assert out["used"] == ["forward_ops", "int8_labels", "param_spec",
                           "prepare_int8"]
    assert "mfu.serve" in out["traced"]["metrics"]


def test_per_layer_metric_without_workloads_is_refused():
    """Every per-layer metric lists the cells it reads in; one that lists
    none is refused rather than guessed from what it moves."""
    bench = harness.benchmark()
    wl = bench["workloads"][0]
    bench["per_layer"].append({"name": "x.none", "unit": "ms",
                               "better": "lower", "source": "host_clock",
                               "layer": "device", "moves": "setup_s"})
    with pytest.raises(SystemExit, match="x.none"):
        harness.per_layer_metrics(bench, wl)
