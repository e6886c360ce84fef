"""The yardstick's work counts against a direct sum over the plain
reference's convolutions, and the roofline arithmetic against the peaks.

The reference's served int8 graphs run on the ``meta`` device, where only
shapes are computed, with ``conv2d``, ``conv_transpose2d`` and ``einsum``
wrapped to add up the multiply-adds of every call they make.
"""

from __future__ import annotations

import math

import pytest
import torch
import torch.nn.functional as F

from octbench import harness, work

CONFIGS = ("unet_f32", "relaynet_f64")


def _cfg(name):
    return harness.config(harness.benchmark(), name)


def _meta_q(cfg):
    """Quantised parameters of the reference's shapes on the meta device."""
    meta = torch.device("meta")

    def layer(shape, out_dim=0, **extra):
        return {"w": torch.empty(shape, dtype=torch.float64, device=meta),
                "scale": torch.empty(shape[out_dim], device=meta),
                "bias": torch.empty(shape[out_dim], device=meta), **extra}

    spec = harness.reference(cfg).param_spec(cfg)
    q = {"_s": {k: torch.empty((), device=meta)
                for k in ("blk0_conv0_in", "in")}}
    convs = [shape for _, shape, kind in spec
             if kind in ("conv3x3", "conv7x3")]
    if cfg["model"] == "unet":
        names = [f"blk{i}_conv{j}" for i in range(9) for j in (0, 1)]
        q.update({n: layer(shape) for n, shape in zip(names, convs)})
        cts = [shape for _, shape, kind in spec if kind == "ct"]
        q.update({f"ct{k}": layer(shape, 1) for k, shape in enumerate(cts)})
    else:
        q.update({f"b{i}": layer(shape, alpha=torch.empty((), device=meta))
                  for i, shape in enumerate(convs)})
    head = [shape for _, shape, kind in spec if kind == "head"][0]
    q["head"] = layer(head)
    return q


def _counted_macs(cfg, monkeypatch) -> int:
    total = [0]
    conv2d, convt, einsum = F.conv2d, F.conv_transpose2d, torch.einsum

    def count_conv(x, w, *args, **kwargs):
        y = conv2d(x, w, *args, **kwargs)
        total[0] += y.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def count_convt(x, w, *args, **kwargs):
        y = convt(x, w, *args, **kwargs)
        total[0] += x.numel() * w.shape[1] * w.shape[2] * w.shape[3]
        return y

    def count_einsum(eq, a, b):
        y = einsum(eq, a, b)
        total[0] += y.numel() * b.shape[1]
        return y

    monkeypatch.setattr(F, "conv2d", count_conv)
    monkeypatch.setattr(F, "conv_transpose2d", count_convt)
    monkeypatch.setattr(torch, "einsum", count_einsum)
    ref = harness.reference(cfg)
    side = cfg["image_size"]
    x = torch.empty((1, side, side, 1), device="meta")
    labels = ref.int8_graph(_meta_q(cfg), x)
    assert labels.shape == (1, side, side)
    return total[0]


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_ops_match_the_reference_convs(name, monkeypatch):
    cfg = _cfg(name)
    ops = harness.reference(cfg).forward_ops(cfg)
    assert ops == 2 * _counted_macs(cfg, monkeypatch)


@pytest.mark.parametrize("name, gmac", [("unet_f32", 48.2),
                                        ("relaynet_f64", 67.0)])
def test_forward_macs_near_the_published_counts(name, gmac):
    cfg = _cfg(name)
    assert harness.reference(cfg).forward_ops(cfg) / 2e9 == pytest.approx(
        gmac, rel=0.01)


def test_train_flops_are_three_forwards():
    """``mfu.train`` counts three forwards a B-scan: at that many FLOPs a
    second on each card's bf16 peak it reads 100%."""
    cfg = _cfg("unet_f32")
    flops = 3 * harness.reference(cfg).forward_ops(cfg)
    bscans, chips = 1000, 4
    window = flops * bscans / (chips * work.PEAK["bf16"])
    read = harness.reader("mfu.train")
    assert read({"cfg": cfg, "window_s": window, "bscans": bscans,
                 "chips": chips}) == pytest.approx(100.0, rel=1e-12)


@pytest.mark.parametrize("name, kernel, calls",
                         [("unet_f32", "k1", 18), ("relaynet_f64", "k7", 7)])
@pytest.mark.parametrize("n", [1, 49, 128])
def test_roofline_share_cannot_pass_one(name, kernel, calls, n):
    """The bound of each call is the larger of its operations at the int8
    peak and its bytes at the HBM rate, so a time that no card can beat
    gives a share of at most 1, and the share reaches 1 only there."""
    cfg = _cfg(name)
    f, hw, nc = cfg["width"], cfg["image_size"], cfg["num_classes"]
    if kernel == "k1":
        parts = [work.serving_work(k, s, n, nc) for _, k, s in
                 work.stages(f, hw) if k == "conv3x3_int8"]
    else:
        parts = [work.relaynet_work(h, c, p, n, f) for _, h, c, p in
                 work.relaynet_stages(f, hw)]
    assert len(parts) == calls
    fastest_ms = sum(max(ops / work.PEAK["int8"], nbytes / work.HBM) * 1e3
                     for ops, nbytes in parts)
    least_ms = (work.unet_k1_bounds(f, hw, nc, n) if kernel == "k1"
                else work.relaynet_k7_bounds(f, hw, n))
    assert least_ms == pytest.approx(fastest_ms, rel=1e-12)
    for ops, nbytes in parts:
        t, kind = work.bound(ops, nbytes, work.PEAK["int8"])
        assert t >= ops / work.PEAK["int8"] * 1e3 * (1 - 1e-12)
        assert t >= nbytes / work.HBM * 1e3 * (1 - 1e-12)
        assert kind in ("operations", "bytes")
    assert least_ms / fastest_ms <= 1 + 1e-12


def test_mfu_cannot_pass_one():
    """At the peak rate, a window's operations over the window read 100%."""
    cfg = _cfg("unet_f32")
    ops = harness.reference(cfg).forward_ops(cfg)
    bscans = 1000
    window = ops * bscans / work.PEAK["int8"]
    read = harness.reader("mfu.serve")
    assert math.isclose(read({"cfg": cfg, "window_s": window,
                              "bscans": bscans, "chips": 1}), 100.0)
