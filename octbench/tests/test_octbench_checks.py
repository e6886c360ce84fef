"""The check of ``correct`` fails what it must: runs driven through the
harness (``run.execute``: everything but the look for a card) at a size
that a test run holds, on the CPU, with the timed path broken underneath
or the lower precision put in the program's place, against the committed
limits, at the cells' widths and 64 x 64 B-scans. A sound serving run
passes there too."""

from __future__ import annotations

import pytest

from octbench import harness, run

SEED = 2 ** 31 + 99


def _cell(name: str, **traffic):
    bench = harness.benchmark()
    wl = harness.workload(bench, name)
    cfg = harness.config(bench, wl["config"])
    small = dict(cfg, image_size=64)  # the cell's widths, 64 x 64
    mix = dict(harness.traffic(wl["traffic"]), **traffic)
    return bench, wl, small, mix


SERVE = dict(volume_sizes=[2, 3, 5], pool_bscans=16, trace_seconds=0.2)
TRAIN = dict(batch_per_chip=4, rows=20, trace_seconds=0.2)


@pytest.mark.parametrize("name", ["unet_f32.bulk_volumes",
                                  "relaynet_f64.bulk_volumes"])
@pytest.mark.parametrize("fault, control, correct", [
    (None, None, True),
    ("altered", None, False),
    (None, "int4", False),
])
def test_serving_check(name, fault, control, correct):
    bench, wl, cfg, mix = _cell(name, **SERVE)
    line = run.execute(bench, wl, cfg, mix, SEED, 0.5, False, device="cpu",
                       fault=fault, control=control)
    assert line["correct"] is correct, line["checks"]
    assert list(line)[-1] == "checks"


def _failed(line) -> set[str]:
    return {k for k, c in line["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("fault, control, fails", [
    ("unchanged", None, "grad_norm_gap"),
    ("half_batch", None, "stem_stats_gap"),
    (None, "fp8", "stem_stats_gap")])
def test_training_check(fault, control, fails):
    bench, wl, cfg, mix = _cell("unet_f32.train_b32", **TRAIN)
    line = run.execute(bench, wl, cfg, mix, SEED, 0.0, False, device="cpu",
                       fault=fault, control=control)
    assert line["correct"] is False, line["checks"]
    assert fails in _failed(line), line["checks"]


def test_data_parallel_check_without_the_exchange():
    """Two gloo ranks whose step skips the all-reduces: the ranks'
    parameters part, which the exact rank check sees."""
    bench, wl, cfg, mix = _cell("unet_f32.train_dp4_b32", chips=2, **TRAIN)
    line = run.execute(bench, wl, cfg, mix, SEED, 0.0, False, device="cpu",
                       fault="no_exchange")
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["rank_param_gap"]["value"] > 0.0


@pytest.mark.parametrize("fault", ["unreduced_stats", "half_batch"])
def test_data_parallel_check_sees_the_rows_left_out(fault):
    """Two gloo ranks whose BatchNorm statistics come from part of the
    global batch (K6's sums left on their rank, or half of the batch left
    out): the gradients are still summed, so the ranks stay equal, and the
    first BatchNorm's statistics fail."""
    bench, wl, cfg, mix = _cell("unet_f32.train_dp4_b32", chips=2, **TRAIN)
    line = run.execute(bench, wl, cfg, mix, SEED, 0.0, False, device="cpu",
                       fault=fault)
    assert line["correct"] is False, line["checks"]
    assert line["checks"]["rank_param_gap"]["value"] == 0.0
    assert "stem_stats_gap" in _failed(line), line["checks"]
