"""The plain reference against the program, at small sizes on the CPU (the
program's kernels run their plain versions there), and at the cell's size
on the card.

A test may import the program; the reference itself may not
(``test_octbench_imports.py``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from octbench import data, harness, weights
from octbench.drivers import serve_volumes, train_steps
from octbench.reference import unet

PROGRAM = harness.PROGRAM


def _small(name: str, width: int, side: int = 64) -> dict:
    cfg = harness.config(harness.benchmark(), name)
    return dict(cfg, width=width, image_size=side)


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _served_pair(cfg, seed, device, n):
    forward = serve_volumes.build(cfg, seed, device)
    images, _ = data.make_rows(seed + 1, n, cfg["image_size"],
                               cfg["num_classes"], device, grey_gain=160.0)
    x = torch.from_numpy(images).to(device)
    got = forward(x.unsqueeze(-1)).cpu()
    ref = harness.reference(cfg)
    q = ref.prepare_int8(weights.make(cfg, seed, device), cfg["image_size"],
                         seed, device)
    return got, ref.int8_labels(q, x).cpu()


@pytest.mark.parametrize("name, width, seed",
                         [("unet_f32", 8, 3), ("unet_f32", 16, 2 ** 33 + 5),
                          ("relaynet_f64", 16, 7)])
def test_int8_graph_equals_the_program(name, width, seed):
    got, want = _served_pair(_small(name, width), seed, "cpu", 3)
    assert got.dtype == want.dtype == torch.int8
    assert torch.equal(got, want)
    assert len(torch.unique(want)) >= 3  # the labels spread over classes


@pytest.mark.parametrize("name", ["unet_f32", "relaynet_f64"])
def test_four_bit_graph_differs(name):
    """The control's precision moves labels that the check can see."""
    cfg = _small(name, 8 if name == "unet_f32" else 16)
    ref = harness.reference(cfg)
    images, _ = data.make_rows(12, 3, 64, 10, "cpu", grey_gain=160.0)
    x = torch.from_numpy(images)
    p = weights.make(cfg, 11, "cpu")
    eight = ref.int8_labels(ref.prepare_int8(p, 64, 11, "cpu"), x)
    four = ref.int8_labels(ref.prepare_int8(p, 64, 11, "cpu", lim=7), x,
                           lim=7)
    assert (eight != four).float().mean() > 0.01


def _program_float_step(cfg, p0, x, y):
    """The program's generic train step in float32 on the same weights."""
    import importlib

    registry = importlib.import_module(f"{PROGRAM}.registry")
    trainer = importlib.import_module(f"{PROGRAM}.training.trainer")
    state = importlib.import_module(f"{PROGRAM}.training.train_state")
    config = importlib.import_module(f"{PROGRAM}.config")
    losses = importlib.import_module(f"{PROGRAM}.training.losses")
    model = registry.get_model("unet", in_channels=1,
                               num_classes=cfg["num_classes"],
                               init_features=cfg["width"])
    model.load_state_dict(p0, strict=False)
    st = state.create_train_state(model, config.OptimConfig())
    step = trainer.make_train_step(losses.dice_ce_loss, None, torch.float32)
    prep = importlib.import_module(f"{PROGRAM}.ops.preprocess")
    loss = step(st, prep.preprocess(x), y.long())
    return float(loss), {k: p.grad for k, p in model.named_parameters()}


def test_train_step_follows_the_program_in_float32():
    cfg = _small("unet_f32", 8)
    p0 = weights.make(cfg, 5, "cpu")
    images, labels = data.make_rows(6, 4, 64, 10, "cpu")
    x, y = torch.from_numpy(images[..., None]), torch.from_numpy(labels)
    loss, grads = _program_float_step(cfg, p0, x, y)
    ref = unet.train_steps(p0, [(x, y)], 1e-3)
    assert ref["loss"][0] == pytest.approx(loss, rel=1e-5)
    for k, g in grads.items():
        r = ref["grad"][k]
        cos = float((g * r).sum() / (g.norm() * r.norm()))
        assert cos > 0.9999, k
        assert float(g.norm()) == pytest.approx(float(r.norm()), rel=1e-3)


def _dp_rank(cfg, images, labels):
    import torch.distributed as dist

    r, n = dist.get_rank(), dist.get_world_size()
    per = images.shape[0] // n
    x = torch.from_numpy(images[..., None])[r * per:(r + 1) * per]
    y = torch.from_numpy(labels)[r * per:(r + 1) * per]
    out = unet.train_steps(weights.make(cfg, 5, "cpu"), [(x, y), (x, y)],
                           1e-3)
    return out["loss"], out["grad"], out["params"]


def test_data_parallel_reference_is_the_whole_batch():
    """Two ranks with half the rows each take the one-rank step."""
    import importlib

    launch = importlib.import_module(f"{PROGRAM}.parallel.launch")
    cfg = _small("unet_f32", 8)
    images, labels = data.make_rows(6, 4, 64, 10, "cpu")
    whole = unet.train_steps(
        weights.make(cfg, 5, "cpu"),
        [(torch.from_numpy(images[..., None]), torch.from_numpy(labels))] * 2,
        1e-3)
    ranks = launch.run_ranks(_dp_rank, 2, cfg, images, labels,
                             backend="gloo")
    p0 = weights.make(cfg, 5, "cpu")
    for loss, grads, params in ranks:
        assert loss == pytest.approx(whole["loss"], rel=1e-5)
        for k, g in grads.items():
            w = whole["grad"][k]
            assert float((g - w).norm()) <= 1e-4 * float(w.norm()), k
        for k, p in params.items():
            moved, want = (p - p0[k]).norm(), (whole["params"][k]
                                               - p0[k]).norm()
            assert float(moved) == pytest.approx(float(want), rel=1e-3), k


def test_first_bn_statistics_follow_the_program():
    """The program's packed bf16 step (its plain versions on the CPU)
    reads the first BatchNorm's statistics of the reference at the
    configuration's compute precision to within the sums' rounding, on
    rows that differ as the training traffic draws them."""
    cfg = _small("unet_f32", 8)
    mix = dict(harness.traffic("train_b32"), batch_per_chip=4, rows=12)
    for seed in (3, 2 ** 31 + 7):
        ranks = train_steps.run_jobs(cfg, mix, [dict(
            seed=seed, seconds=0.0, trace=False, fault=None,
            control=None)], "cpu")[0]
        stem = ranks[0]["readings"]["stem_stats"]
        assert stem < 1e-5, stem


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["unet_f32", "relaynet_f64"])
def test_int8_graph_equals_the_program_on_the_card(name, card):
    """At the cell's widths and 512 x 512, on the card's kernels."""
    cfg = harness.config(harness.benchmark(), name)
    got, want = _served_pair(cfg, 2 ** 31 + 17, card, 4)
    share = float((got != want).float().mean())
    assert share <= harness.limits(f"{name}.bulk_volumes")[
        "label_mismatch_share"]
    assert np.unique(want.numpy()).size >= 5
