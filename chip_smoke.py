#!/usr/bin/env python3
"""Drive the PyTorch port's int8 serving paths (U-Net and ReLayNet) and
its U-Net training path (with and without the fused Dice+CE loss) once on
one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises; the exit code is then non-zero):

1. device: card name and power limit, versions, compute capability 9.0,
   and the build of the CUDA kernels from ``csrc/``;
2. kernels: every stage of the served graph (f=32, 512x512, batch 2) on
   its kernel and on the kernel's plain PyTorch version, bit for bit;
3. graph: the U-Net (f=32, 10 classes, seeded random weights), folded,
   calibrated and quantized; labels of the kernel graph identical to the
   plain graph's at batch 8, and agreeing with the all-int8 oracle
   (> 0.995) and the float graph (> 0.95);
4. serve: the ServingLoop and HTTP server built as the CLI builds them,
   12 requests from 3 client threads; every response equals the direct
   forward, and every forward launched K1 18 times, K2 4 times, K3 once;
5. times on the card (CUDA events): each kernel against its plain version
   at batch 32, the served forward at batch 32 and 128, serve latency;
6. training kernels: K4 (forward and dgrad) and K5 at the 17 non-stem 3x3
   conv shapes of the f=32 U-Net at 512x512, batch 8 (the train step's),
   on integer inputs, bit-equal to the plain versions; K6 in both modes at
   the 18 BatchNorm shapes, batch 8, within rtol 1e-6 of the float64 plain
   version (N(1, 1) inputs);
7. train: the trainer as ``cli train --packed`` builds it (f=32, 10 classes,
   512x512 synthetic data, batch 8, Adam 1e-3), five steps: loss finite and
   lower at step 5 than at step 1, and K4/K5/K6 launched 6/3/36 times per
   step; from the state those steps reached, one step on the kernels
   against the same step with the plain versions patched in (``GATE``:
   loss, and per gradient tensor above a norm of 1e-3 the cosine and the
   norm), and two planted kernel faults that this gate must reject;
   launches per step with ``mid=deep="kernel"`` 34/17/36;
8. times on the card: each training kernel summed over the step's calls at
   batch 8 against its plain version and one library call, the train step
   at batch 8 and 16 in both conv settings (and the library-conv step),
   peak memory, and a ``torch.profiler`` breakdown of the step;
9. fused-loss kernels: K8 and K9 at the train step's logits (8, 512, 512,
   10) bf16 with int64 labels, uniform and class weights: K8 within rtol
   1e-5 of the float64 plain version, K9 within one bf16 ulp of the
   float64 dlogits (plus an fp32 floor of 2^-20 of the largest);
10. fused-loss training: five steps of ``cli train --packed`` with
    ``OCTSEG_PACKED_FUSED_LOSS=1``: loss finite and falling, K8/K9
    launched once each per step (K4-K6 as in phase 7); from the state
    those steps reached, the fused step against the unfused step
    (``FUSED_GATE``) and two planted K8/K9 faults the gate must reject;
11. times: K8 and K9 against their plain versions, both losses' forward +
    backward, and the train step at batch 8 with and without the fused
    loss (in turns: unfused, fused, fused, unfused);
12. ReLayNet kernels: K7 at its 7 stage shapes (f=64, 512x512, batch 2),
    bit for bit against its plain version (pool values and indices too);
13. ReLayNet graph (f=64, 10 classes, seeded random weights, batch 8):
    labels identical to the plain graph's, agreement with the all-int8
    oracle > 0.995 and the float graph > 0.95;
14. ReLayNet served as ``cli serve --model relaynet`` builds it: 6 HTTP
    requests, each equal to the direct forward; K7 7 and K3 1 launches
    per forward;
15. ReLayNet times at batch 32: K7 per stage and summed, against its plain
    version and its bound, and the served forward;
16. K10 (the fused stem) and K11 (the int8 pool) bit for bit against their
    plain versions: K10 at (2, 512, 512) with f=32 and f=16 and at the
    non-square (2, 80, 48), K11 at the packed graph's deep pool shapes
    (batch 2) and a C=24 shape;
17. the PSRP graph of phase 3 with the fused stem: labels identical to the
    unfused graph's at batch 8, launches per forward K10 1, K1 16, K2 4,
    K3 1;
18. the row-packed graph (``infer --quantize packed``) of the same model at
    batch 8: labels identical to its plain graph's, agreement with the
    all-int8 oracle > 0.995 and the float graph > 0.95, launches per
    forward K1 18, K11 2, K2 4, K3 1;
19. ``cli infer`` at 512x512 on 4 B-scans: ``--quantize packed`` and
    ``psrp``, ``--save-quantized`` then ``--load-quantized`` writing the
    same masks, ReLayNet ``psrp``;
20. ``cli eval --quantize psrp`` at 512x512, ``--num-val 8``: the confusion
    counts sum to the pixel count, and the metrics equal the same masks
    scored on the CPU within 1e-4;
21. times at batch 32: K10 against K1 (stem) + K1 (blk0_conv1, pool), K11
    against its bound and one PyTorch call (``amax``), the packed forward
    and the PSRP forward with the fused stem off and on at batch 32 and 128,
    and ``Trainer.evaluate`` per batch of 8.

The last lines are the card's name and power limit, a JSON object with the
kernels, then ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

F, NC, HW = 32, 10, 512
SEED = 0
TRAIN_BATCH = 8
# H100 SXM published dense peaks and HBM rate (NVIDIA data sheet)
PEAK = {"int8": 1979e12, "bf16": 989e12, "fp32": 67e12}
HBM = 3.35e12

# TPU kernels each port kernel replaces (JAX package, file:line of the def)
_JAX = "retinal_oct_image_segmentation_via_deep_learning_tpu/ops/"
REPLACES = {
    "conv3x3_int8": [_JAX + "pallas_conv_psrp.py:442 conv3x3_psrp",
                     _JAX + "pallas_conv_psrp.py:777 stem_psrp",
                     _JAX + "pallas_conv_int8.py:204 conv3x3_int8",
                     _JAX + "pallas_conv_packed.py:213 conv3x3_int8_packed",
                     _JAX + "pallas_conv_packed.py:338 stem_conv3x3_int8_packed"],
    "ct2x2_int8": [_JAX + "pallas_conv_int8.py:323 ct2x2_int8",
                   _JAX + "pallas_conv_psrp.py:603 ct_up_psrp",
                   _JAX + "pallas_conv_psrp.py:676 ct_psrp"],
    "head_argmax": [_JAX + "pallas_conv_psrp.py:1074 head_argmax_psrp",
                    _JAX + "pallas_conv_packed.py:420 head_argmax_packed"],
    "conv3x3_bf16": [_JAX + "pallas_conv_bf16.py:121 _conv_fwd_pallas"],
    "conv3x3_bf16_wgrad": [_JAX + "pallas_conv_bf16.py:220 _conv_wgrad_pallas"],
    "bn_pair_sums": [_JAX + "fused_bn.py:66 _pallas_pair_sums"],
    "conv7x3_int8": [_JAX + "pallas_conv_psrp7.py:197 conv7x3_psrp",
                     _JAX + "pallas_conv_psrp7.py:360 stem7_psrp"],
    "dice_ce_stats": [_JAX + "pallas_loss.py:141 _run_fwd"],
    "dice_ce_bwd": [_JAX + "pallas_loss.py:187 _bwd"],
    "stem_conv_int8": [_JAX + "pallas_conv_psrp.py:964 stem_conv_psrp"],
    "pool2x2_int8": [_JAX + "pallas_conv_int8.py:377 pool2x2_int8"],
}
_PKG = "retinal_oct_image_segmentation_via_deep_learning_tpu_torch/"
SOURCES = {"conv3x3_int8": _PKG + "csrc/conv3x3_int8.cu",
           "ct2x2_int8": _PKG + "csrc/ct2x2_int8.cu",
           "head_argmax": _PKG + "csrc/head_argmax.cu",
           "conv3x3_bf16": _PKG + "csrc/conv3x3_bf16.cu",
           "conv3x3_bf16_wgrad": _PKG + "csrc/conv3x3_bf16.cu",
           "bn_pair_sums": _PKG + "csrc/bn_pair_sums.cu",
           "conv7x3_int8": _PKG + "csrc/conv7x3_int8.cu",
           "dice_ce_stats": _PKG + "csrc/dice_ce.cu",
           "dice_ce_bwd": _PKG + "csrc/dice_ce.cu",
           "stem_conv_int8": _PKG + "csrc/stem_conv_int8.cu",
           "pool2x2_int8": _PKG + "csrc/pool2x2_int8.cu"}
# kernel step vs plain-version step from the trained state: relative loss,
# lowest gradient cosine and largest change of a gradient's norm, each
# between the kernels' own floor (a one-ulp input change) and two planted
# kernel faults (PERF.md section 6)
GATE = {"loss": 1e-5, "cosine": 0.9999, "norm": 3e-3}
# the fused-loss step vs the unfused step from the trained state: the same
# three readings, each near the geometric middle of the one-ulp floor and
# the nearest of two planted K8/K9 faults (PERF.md section 6)
FUSED_GATE = {"loss": 1e-5, "cosine": 0.9997, "norm": 2e-3}
RELAYNET_F = 64
RELAYNET_GAIN = 0.75  # the 7x3 weights' scale in phase 13 (see there)
RELAYNET_LAUNCHES = {"conv7x3_int8": 7, "head_argmax": 1}
LAUNCHES_PER_FORWARD = {"conv3x3_int8": 18, "ct2x2_int8": 4,
                        "head_argmax": 1}
FUSED_STEM_LAUNCHES = {"stem_conv_int8": 1, "conv3x3_int8": 16,
                       "ct2x2_int8": 4, "head_argmax": 1}
INFER_BATCH = 4  # B-scans per cli infer run (phase 19)
LAUNCHES_PER_STEP = {
    "torch": {"conv3x3_bf16": 6, "conv3x3_bf16_wgrad": 3, "bn_pair_sums": 36},
    "kernel": {"conv3x3_bf16": 34, "conv3x3_bf16_wgrad": 17,
               "bn_pair_sums": 36},
}


def stages(f=F, hw=HW):
    """Every kernel call of one forward: (name, kernel, shape args).
    conv: (H, cins, cout, pool); ct: (H_in, cin, cout); head: (H, cin)."""
    out = [("stem blk0_conv0", "conv3x3_int8", (hw, (1,), f, False)),
           ("blk0_conv1", "conv3x3_int8", (hw, (f,), f, True))]
    h, c = hw // 2, f
    for i in range(1, 4):  # blk1..blk3
        out += [(f"blk{i}_conv0", "conv3x3_int8", (h, (c,), 2 * c, False)),
                (f"blk{i}_conv1", "conv3x3_int8", (h, (2 * c,), 2 * c, True))]
        h, c = h // 2, 2 * c
    out += [("blk4_conv0", "conv3x3_int8", (h, (c,), 2 * c, False)),
            ("blk4_conv1", "conv3x3_int8", (h, (2 * c,), 2 * c, False))]
    c *= 2
    for k, blk in enumerate((5, 6, 7, 8)):
        out.append((f"ct{k}", "ct2x2_int8", (h, c, c // 2)))
        h, c = 2 * h, c // 2
        out += [(f"blk{blk}_conv0", "conv3x3_int8", (h, (c, c), c, False)),
                (f"blk{blk}_conv1", "conv3x3_int8", (h, (c,), c, False))]
    out.append(("head", "head_argmax", (h, c)))
    return out


def train_convs():
    """The 17 non-stem 3x3 convs of the U-Net: (name, H, cin, cout, setting
    that puts them on K4: "always" | "mid" | "deep")."""
    f, hw = F, HW
    out = [("blk0_conv1", hw, f, f, "always")]
    h, c = hw // 2, f
    for i in range(1, 5):
        group = "mid" if i == 1 else "deep"
        out += [(f"blk{i}_conv0", h, c, 2 * c, group),
                (f"blk{i}_conv1", h, 2 * c, 2 * c, group)]
        h, c = h // 2, 2 * c
    for blk, h, c, group in ((5, hw // 8, 8 * f, "deep"),
                             (6, hw // 4, 4 * f, "deep"),
                             (7, hw // 2, 2 * f, "mid"),
                             (8, hw, f, "always")):
        out += [(f"blk{blk}_conv0", h, 2 * c, c, group),
                (f"blk{blk}_conv1", h, c, c, group)]
    return out


def tpu_row(name, kernel, shape):
    """The TPU kernel (ROADMAP Queue B id) that ran a serving stage in the
    JAX graph: PSRP kernels at 512^2 and 256^2, NHWC int8 ones below."""
    if kernel == "head_argmax":
        return "B7"
    if kernel == "ct2x2_int8":
        return {"ct2": "B5", "ct3": "B6"}.get(name, "B4")
    if name.startswith("stem"):
        return "B2"
    return "B1" if shape[0] >= 256 else "B3"


def bn_shapes():
    """(H, C) of the 18 BatchNorms: the stem's and each conv's."""
    return [(HW, F)] + [(h, cout) for _, h, _, cout, _ in train_convs()]


def bound(ops, nbytes, peak):
    """(least time in ms, "operations" or "bytes") for ``ops`` at ``peak``
    op/s and ``nbytes`` at the HBM rate."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def serving_work(kernel, shape, n):
    """(int8 ops, bytes) of one serving-stage call at batch n: each input
    read once, each output written once."""
    if kernel == "conv3x3_int8":
        h, cins, cout, pool = shape
        cin = sum(cins)
        out = n * h * h * cout * (1.25 if pool else 1)
        return (2 * n * h * h * 9 * cin * cout,
                n * h * h * cin + 9 * cin * cout + 8 * cout + out)
    if kernel == "ct2x2_int8":
        h, cin, cout = shape
        return (2 * n * h * h * cin * cout * 4,
                n * h * h * cin + 4 * cin * cout + 8 * cout
                + n * 4 * h * h * cout)
    h, cin = shape
    return (2 * n * h * h * cin * NC,
            n * h * h * cin + cin * NC + 8 * NC + n * h * h)


def relaynet_stages(f, hw):
    """ReLayNet's K7 calls of one forward: (name, H, cins, pool)."""
    return [("b0 stem", hw, (1,), True), ("b1", hw // 2, (f,), True),
            ("b2", hw // 4, (f,), True), ("b3", hw // 8, (f,), False),
            ("b4", hw // 4, (f, f), False), ("b5", hw // 2, (f, f), False),
            ("b6", hw, (f, f), False)]


def relaynet_work(h, cins, pool, n, f=64):
    """(int8 ops, bytes) of one K7 call at batch n: each input read once,
    each output (with the pool: the pooled values and the indices too)
    written once."""
    cin = sum(cins)
    return (2 * n * h * h * 21 * cin * f,
            n * h * h * cin + 21 * cin * f + 8 * f
            + n * h * h * f * (1.5 if pool else 1))


T_START = time.perf_counter()


def train_batch(dev, n, seed):
    """Seeded synthetic Duke-DME-shaped B-scans (z-scored) and labels."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
        SyntheticOCTConfig,
        synth_batch,
    )

    gb = torch.Generator(device=dev).manual_seed(seed)
    images, labels = synth_batch(gb, n, SyntheticOCTConfig(
        height=HW, width=HW, num_layers=NC - 2))
    return preprocess(images), labels


def seeded_unet(dev):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
    )

    return get_model("unet", num_classes=NC, init_features=F,
                     seed=SEED).to(dev)


def train_cli_args():
    """``cli train --packed`` at f=F, NC classes, HW^2, TRAIN_BATCH, Adam
    1e-3, five one-step epochs."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli

    return cli.parser().parse_args([
        "train", "--packed", "--image-size", str(HW), "--num-classes",
        str(NC), "--batch-size", str(TRAIN_BATCH), "--num-train",
        str(TRAIN_BATCH), "--num-val", str(TRAIN_BATCH), "--epochs", "5",
        "--lr", "1e-3", "--optimizer", "adam", "--device", "cuda",
        "--model-kwargs", json.dumps({"init_features": F})])


def one_ulp_change(x, dev):
    """``x`` in bf16 with one ulp added to 1e-4 of its elements (seeded):
    how far a step moves under a rounding-sized change of its input."""
    import torch

    gp = torch.Generator(device=dev).manual_seed(SEED + 40)
    xi = x.to(torch.bfloat16).view(torch.int16)
    hit = torch.rand(xi.shape, generator=gp, device=dev) < 1e-4
    return torch.where(hit, xi + 1, xi).view(torch.bfloat16)


def agreement(a, b):
    """Of two (loss, {name: gradient}) results: (relative loss difference,
    (lowest gradient cosine, its tensor), (largest |norm ratio - 1|, its
    tensor)), over the tensors above a norm of 1e-3."""
    cos, ratio = (1.0, ""), (0.0, "")
    for n in a[1]:
        u, v = a[1][n].flatten(), b[1][n].flatten()
        nu, nv = float(u.norm()), float(v.norm())
        if max(nu, nv) > 1e-3:
            cos = min(cos, (float(u @ v) / (nu * nv), n))
            ratio = max(ratio, (abs(nu / nv - 1), n))
    return abs(a[0] - b[0]) / abs(b[0]), cos, ratio


def gate_passes(agree, gate):
    """A gate set between the one-ulp floor and planted faults (PERF.md
    section 6)."""
    return agree[0] < gate["loss"] and agree[1][0] > gate["cosine"] \
        and agree[2][0] < gate["norm"]


def reading(agree):
    return (f"relative loss {agree[0]:.2e}, lowest cosine "
            f"{agree[1][0]:.6f} ({agree[1][1]}), largest norm change "
            f"{agree[2][0]:.2e} ({agree[2][1]})")


def profile_breakdown(fn, runs, what, groups):
    """``torch.profiler`` over ``runs`` calls of ``fn``: wall and device
    busy time per call, device time by kernel group (name substring) and
    the 15 largest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total = sum(dev_us(e) for e in kern) / 1e3
    if total <= 0:
        print("profiler: no device time recorded (not measured)")
        return
    by_group = {gname: sum(dev_us(e) for e in kern if key in e.key) / 1e3
                for gname, key in groups.items()}
    by_group["everything else"] = total - sum(by_group.values())
    print(f"profile, {runs} x {what}: wall {wall_ms / runs:.3f} ms each, "
          f"device busy {total / runs:.3f} ms ({100 * total / wall_ms:.2f}%), "
          f"idle {100 * (1 - total / wall_ms):.2f}%")
    for gname, t in by_group.items():
        print(f"  {gname:24s} {t / runs:8.3f} ms {100 * t / total:6.2f}%")
    for e in sorted(kern, key=dev_us, reverse=True)[:15]:
        print(f"  {dev_us(e) / runs / 1e3:8.3f} ms "
              f"{100 * dev_us(e) / 1e3 / total:6.2f}%  {e.key[:100]}")


def http_post(url, arr):
    """POST one array to the server's /predict; -> the returned array."""
    buf = io.BytesIO()
    np.save(buf, arr)
    req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return np.load(io.BytesIO(r.read()), allow_pickle=False)


def phase(name):
    print(f"\n=== {name} === (at {time.perf_counter() - T_START:.1f} s)",
          flush=True)


@contextlib.contextmanager
def swapped(module, **repl):
    """Put ``repl``'s functions in place of ``module``'s entry points of the
    same names (the op modules look their wrappers up by name at call
    time)."""
    saved = {k: getattr(module, k) for k in repl}
    for k, v in repl.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def train_phases(dev, card, time_ms):
    """Phases 6-8: the training path. -> the K4-K6 entries of the kernels
    line."""
    import torch
    import torch.nn.functional as tnf

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        OptimConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_bf16 as k45,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        packed_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
        dice_ce_loss,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
        create_train_state,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        make_train_step,
    )

    bf16 = torch.bfloat16
    names = ("conv3x3_bf16", "conv3x3_bf16_wgrad", "bn_pair_sums")

    def wrappers():
        return {"conv3x3_bf16": k45.conv3x3_bf16_fwd,
                "conv3x3_bf16_wgrad": k45.conv3x3_bf16_wgrad,
                "bn_pair_sums": k6.pair_sums}

    def reset():
        for w in wrappers().values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in wrappers().items()}

    g = torch.Generator(device=dev).manual_seed(SEED + 10)

    def ints(shape):
        return torch.randint(-2, 3, shape, generator=g, device=dev).to(bf16)

    def normal(shape, mean=0.0):
        return (torch.randn(shape, generator=g, device=dev) + mean).to(bf16)

    def batch(n, seed):
        return train_batch(dev, n, seed)

    def unet():
        return seeded_unet(dev)

    # ------------------------------------------------------------------ 6
    phase(f"6 training kernels vs plain versions (batch {TRAIN_BATCH})")
    max_err = {k: 0.0 for k in names}
    bad = 0
    nb = TRAIN_BATCH
    for name, h, cin, cout, group in train_convs():
        x, w, dy = ints((nb, h, h, cin)), ints((3, 3, cin, cout)), \
            ints((nb, h, h, cout))
        got = (k45.conv3x3_bf16_fwd(x, w),
               k45.conv3x3_bf16_fwd(dy, k45.flip_w(w)),
               k45.conv3x3_bf16_wgrad(x, dy))
        want = (k45.conv3x3_bf16_reference(x, w),
                k45.conv3x3_bf16_dgrad_reference(dy, w),
                k45.conv3x3_bf16_wgrad_reference(x, dy))
        torch.cuda.synchronize()
        mism = [int((a != b).sum()) for a, b in zip(got, want)]
        for k, a, b in zip(("conv3x3_bf16", "conv3x3_bf16",
                            "conv3x3_bf16_wgrad"), got, want):
            max_err[k] = max(max_err[k],
                             float((a.float() - b.float()).abs().max()))
        print(f"{name:11s} {h:4d}^2 {cin:4d}->{cout:4d} ({group:6s}) "
              f"mismatches fwd {mism[0]} dgrad {mism[1]} wgrad {mism[2]}",
              flush=True)
        bad += sum(mism)
        del x, w, dy, got, want
    worst_rel = 0.0
    for h, c in bn_shapes():
        for two in (False, True):
            a = normal((nb, h, h, c), 1.0)
            b = normal((nb, h, h, c), 1.0) if two else None
            got = k6.pair_sums(a, b)
            want = k6.pair_sums_reference(a, b)
            torch.cuda.synchronize()
            err = (got - want).abs()
            rel = float((err / want.abs()).max())
            max_err["bn_pair_sums"] = max(max_err["bn_pair_sums"],
                                          float(err.max()))
            worst_rel = max(worst_rel, rel)
            if rel > 1e-6:
                print(f"K6 {h}^2 x {c} two={two}: relative error {rel:.3e}")
                bad += 1
    print(f"K6 at the 18 BN shapes, both modes: worst relative error "
          f"{worst_rel:.3e} (limit 1e-6), max abs {max_err['bn_pair_sums']:.3e}")
    if bad:
        raise RuntimeError(f"{bad} training-kernel checks failed")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 7
    phase(f"7 train: cli train --packed (f={F}, {NC} classes, {HW}x{HW}, "
          f"batch {TRAIN_BATCH}, Adam 1e-3), five steps")
    trainer, train_ds, val_ds = cli.build_training(train_cli_args())
    reset()
    t0 = time.perf_counter()
    trained = trainer.fit(train_ds, val_ds).model.state_dict()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = counts()
    losses = [r["train_loss"] for r in trainer.history]
    for r in trainer.history:
        print(f"epoch {r['epoch']} (one step): train_loss {r['train_loss']:.6f}"
              f" val_loss {r['val_loss']:.6f} time {r['time_s']:.3f} s")
    print(f"fit: {fit_s:.2f} s for 5 steps + 5 validations; launches "
          f"{launches}, expected 5 x {LAUNCHES_PER_STEP['torch']}", flush=True)
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train losses {losses}")
    if not losses[4] < losses[0]:
        raise RuntimeError(f"loss did not go down: {losses}")
    if any(launches[k] != 5 * v for k, v in LAUNCHES_PER_STEP["torch"].items()):
        raise RuntimeError("launch counts do not match the train step")
    del trainer, train_ds, val_ds
    torch.cuda.empty_cache()

    x8, y8 = batch(TRAIN_BATCH, SEED + 20)

    def loss_and_grads(weights, x=x8):
        model = unet()
        if weights is not None:
            model.load_state_dict(weights)
        logits, _ = packed_unet.packed_unet_apply(model, x)
        loss = dice_ce_loss(logits, y8)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().double()
                                      for n, p in model.named_parameters()}

    def passes(agree):
        return gate_passes(agree, GATE)

    # beside each comparison, the same kernel step with one bf16 ulp added
    # to 1e-4 of the input pixels: how far the function itself moves under a
    # rounding-sized change. The gate is the trained state's: at the random
    # init the deep layers' bf16 gradients move that much under such a change
    x_ulp = one_ulp_change(x8, dev)
    for label, weights in (("the random init", None),
                           ("the trained state", trained)):
        kern = loss_and_grads(weights)
        with swapped(k45, conv3x3_bf16_fwd=k45.conv3x3_bf16_reference,
                     conv3x3_bf16_wgrad=k45.conv3x3_bf16_wgrad_reference), \
                swapped(k6, pair_sums=k6.pair_sums_reference):
            agree = agreement(kern, loss_and_grads(weights))
        floor = agreement(kern, loss_and_grads(weights, x_ulp))
        print(f"one step from {label}, kernels vs plain versions: "
              f"{reading(agree)}; kernels on a 1-ulp input change: "
              f"{reading(floor)}", flush=True)

    # planted faults, each a wrong kernel the gate must reject
    wgrad, sums = k45.conv3x3_bf16_wgrad, k6.pair_sums

    def k5_drops_tiles(x, dy):
        """K5 with every 64th 8x16 output tile (its unit of work) left
        out."""
        n, h, w, _ = dy.shape
        keep = torch.ones(n * -(-h // 8) * -(-w // 16), dtype=dy.dtype,
                          device=dy.device)
        keep[::64] = 0
        keep = keep.view(n, -(-h // 8), -(-w // 16))
        mask = keep.repeat_interleave(8, 1)[:, :h].repeat_interleave(16, 2)
        return wgrad(x, (dy * mask[:, :, :w, None]).contiguous())

    def k6_sums_high(a, b=None):
        """K6 with its sums 0.5% high."""
        return sums(a, b) * 1.005

    # the real wrappers count their launches under their module names,
    # which point at the faults while these run
    k5_drops_tiles.launches = k6_sums_high.launches = 0
    faults = {}
    for label, fault in (
        ("K5 leaves out 1/64 of the output tiles",
         swapped(k45, conv3x3_bf16_wgrad=k5_drops_tiles)),
        ("K6 sums 0.5% high", swapped(k6, pair_sums=k6_sums_high)),
    ):
        with fault:
            faults[label] = agreement(kern, loss_and_grads(trained))
        print(f"planted fault, {label}: {reading(faults[label])}", flush=True)
    print(f"gate (the trained state): relative loss < {GATE['loss']}, "
          f"cosine > {GATE['cosine']}, norm change < {GATE['norm']}")
    if not passes(agree):
        raise RuntimeError("kernel step and plain step disagree")
    seen = [label for label, a in faults.items() if not passes(a)]
    if len(seen) != len(faults):
        raise RuntimeError(f"the gate sees only the faults {seen}")
    for setting, want in LAUNCHES_PER_STEP.items():
        state = create_train_state(unet(), OptimConfig())
        step = packed_unet.make_packed_train_step(dice_ce_loss, deep=setting,
                                                  mid=setting)
        reset()
        step(state, x8, y8)
        torch.cuda.synchronize()
        got = counts()
        print(f"launches per step, mid=deep={setting!r}: {got}")
        if got != want:
            raise RuntimeError(f"expected {want}")
    del state, step
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 8
    phase(f"8 training times on {card}")
    nb = TRAIN_BATCH
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
                "operations": 0.0, "bytes": 0.0} for k in names}
    every17 = {k: [0.0, 0.0] for k in ("conv3x3_bf16", "conv3x3_bf16_wgrad")}

    def add(k, main, ms, pms, lms, work, peak):
        b_ms, b_by = bound(*work, peak)
        if main:
            for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                           (b_by, b_ms)):
                rows[k][key] += v
        return b_ms, b_by

    for name, h, cin, cout, group in train_convs():
        main = group == "always"  # on K4 in the default (main path) step
        x, dy = normal((nb, h, h, cin)), normal((nb, h, h, cout))
        w = normal((3, 3, cin, cout))
        wf = k45.flip_w(w)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        xc, dyc = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        ops = 2 * nb * h * h * 9 * cin * cout
        act = 2 * nb * h * h * (cin + cout)
        runs = 10 if main else 3
        with torch.no_grad():
            for label, k, fn, plain, lib, nbytes in (
                ("fwd", "conv3x3_bf16",
                 lambda: k45.conv3x3_bf16_fwd(x, w),
                 lambda: k45.conv3x3_bf16_reference(x, w),
                 lambda: tnf.conv2d(xc, w_oihw, padding=1),
                 act + 2 * 9 * cin * cout),
                ("dgrad", "conv3x3_bf16",
                 lambda: k45.conv3x3_bf16_fwd(dy, wf),
                 lambda: k45.conv3x3_bf16_dgrad_reference(dy, w),
                 lambda: torch.nn.grad.conv2d_input(xc.shape, w_oihw, dyc,
                                                    padding=1),
                 act + 2 * 9 * cin * cout),
                ("wgrad", "conv3x3_bf16_wgrad",
                 lambda: k45.conv3x3_bf16_wgrad(x, dy),
                 lambda: k45.conv3x3_bf16_wgrad_reference(x, dy),
                 lambda: torch.nn.grad.conv2d_weight(xc, w_oihw.shape, dyc,
                                                     padding=1),
                 act + 4 * 9 * cin * cout),
            ):
                ms = time_ms(fn, runs)
                pms = time_ms(plain, 3)
                lms = time_ms(lib, runs)
                b_ms, b_by = add(k, main, ms, pms, lms, (ops, nbytes),
                                 PEAK["bf16"])
                every17[k][0] += ms
                every17[k][1] += lms
                print(f"time b{nb} {name:11s} {label:5s} kernel {ms:.4f} ms "
                      f"({ops / ms / 1e9:.1f} TFLOP/s), plain {pms:.4f}, "
                      f"library {lms:.4f}, bound {b_ms:.4f} ({b_by})"
                      f"{' [main path]' if main else ''}", flush=True)
        del x, dy, w, wf, w_oihw, xc, dyc
        torch.cuda.empty_cache()
    for k, (ms, lms) in every17.items():
        print(f"time b{nb} {k} over all 17 convs (the mid=deep='kernel' "
              f"step): kernel {ms:.4f} ms, library {lms:.4f} ms")
    dims = (0, 1, 2)
    for h, c in bn_shapes():
        a, b = normal((nb, h, h, c), 1.0), normal((nb, h, h, c), 1.0)
        m = nb * h * h
        a2, b2 = a.reshape(m, c), b.reshape(m, c)
        for label, args, lib, nbytes in (
            ("fwd", (a,), lambda: torch.var_mean(a, dim=dims, correction=0),
             2 * m * c + 8 * c),
            ("bwd", (a, b), lambda: torch.linalg.vecdot(a2, b2, dim=0),
             4 * m * c + 8 * c),
        ):
            ms = time_ms(lambda: k6.pair_sums(*args))
            pms = time_ms(lambda: k6.pair_sums_reference(*args), 3)
            lms = time_ms(lib)
            b_ms, b_by = add("bn_pair_sums", True, ms, pms, lms,
                             (3 * m * c, nbytes), PEAK["fp32"])
            print(f"time b{nb} K6 {h:4d}^2 x {c:4d} {label}: kernel {ms:.4f} "
                  f"ms ({nbytes / ms / 1e6:.0f} GB/s), plain {pms:.4f}, "
                  f"library {lms:.4f}, bound {b_ms:.4f} ({b_by})", flush=True)
        del a, b, a2, b2
    for k, r in rows.items():
        print(f"time b{nb} {k} summed over the default step's calls: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f}, bound "
              f"{r['operations'] + r['bytes']:.4f}")
    torch.cuda.empty_cache()

    def step_for(setting, n):
        state = create_train_state(unet(), OptimConfig())
        if setting == "library":
            return state, make_train_step(dice_ce_loss)
        return state, packed_unet.make_packed_train_step(
            dice_ce_loss, deep=setting, mid=setting)

    for setting in ("torch", "kernel", "library"):
        for n in (TRAIN_BATCH, 2 * TRAIN_BATCH):
            xs, ys = batch(n, SEED + 30 + n)
            torch.cuda.reset_peak_memory_stats()
            state, step = step_for(setting, n)
            for _ in range(2):
                step(state, xs, ys)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                loss = step(state, xs, ys)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            peak_gb = torch.cuda.max_memory_allocated() / 1e9
            what = ("packed, mid=deep=" + repr(setting) if setting != "library"
                    else "unpacked UNet, library convs, autocast bf16")
            print(f"train step ({what}) batch {n}: {ms:.3f} ms, "
                  f"{n / ms * 1e3:.1f} B-scans/s, peak memory {peak_gb:.2f} "
                  f"GB, loss {float(loss):.4f}", flush=True)
            del state, step, xs, ys, loss
            torch.cuda.empty_cache()

    state, step = step_for("torch", TRAIN_BATCH)
    for _ in range(2):
        step(state, x8, y8)
    profile_breakdown(lambda: step(state, x8, y8), 3,
                      f"default steps at batch {TRAIN_BATCH}",
                      {"K4 conv3x3_bf16": "conv3x3_bf16_fwd",
                       "K5 conv3x3_bf16_wgrad": "conv3x3_bf16_wgrad",
                       "K6 bn_pair_sums": "pair_sums"})
    del state, step

    return [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": "; ".join(REPLACES[k]), "launches": launches[k],
        "max_abs_err": max_err[k], "ms": rows[k]["ms"],
        "plain_ms": rows[k]["plain_ms"],
        "bound_ms": rows[k]["operations"] + rows[k]["bytes"],
        "bound_by": ("operations" if rows[k]["operations"]
                     >= rows[k]["bytes"] else "bytes"),
        "library_ms": rows[k]["library_ms"],
    } for k in names]


def k9_within_ulp(dx, exact):
    """K9's dlogits against the float64 ones: (elements beyond one ulp of
    dx's dtype plus the fp32 floor of 2^-20 of the largest, largest error
    in ulps). The floor: dlogit is an fp32 sum of terms as large as the
    largest element, which can cancel."""
    import torch

    want = exact.to(dx.dtype).float().abs().clamp_min(2.0 ** -126)
    if dx.dtype == torch.bfloat16:
        ulp = torch.exp2(torch.floor(torch.log2(want)) - 7)
    else:
        ulp = want * 2.0 ** -23
    err = (dx.double() - exact).abs()
    floor = 2.0 ** -20 * float(exact.abs().max())
    return (int((err > ulp.double() + floor).sum()),
            float((err / ulp.double()).max()))


def fused_loss_phases(dev, card, time_ms):
    """Phases 9-11: the fused Dice+CE loss (K8, K9) on the packed train
    step. -> the K8 and K9 entries of the kernels line."""
    import os

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        OptimConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_bf16 as k45,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        dice_ce as k89,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        packed_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
        dice_ce_loss,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
        create_train_state,
    )

    names = ("dice_ce_stats", "dice_ce_bwd")
    every = {"conv3x3_bf16": k45.conv3x3_bf16_fwd,
             "conv3x3_bf16_wgrad": k45.conv3x3_bf16_wgrad,
             "bn_pair_sums": k6.pair_sums,
             "dice_ce_stats": k89.dice_ce_stats,
             "dice_ce_bwd": k89.dice_ce_bwd}

    def reset():
        for w in every.values():
            w.launches = 0

    def counts():
        return {k: w.launches for k, w in every.items()}

    def batch(n, seed):
        return train_batch(dev, n, seed)

    def unet():
        return seeded_unet(dev)

    nb, P = TRAIN_BATCH, TRAIN_BATCH * HW * HW
    g = torch.Generator(device=dev).manual_seed(SEED + 50)
    logits = (torch.randn((nb, HW, HW, NC), generator=g, device=dev)
              * 3).to(torch.bfloat16)
    labels = torch.randint(0, NC, (nb, HW, HW), generator=g, device=dev)
    weights = {"uniform": torch.ones(NC, device=dev),
               "class weights": torch.linspace(0.5, 2.0, NC, device=dev)}

    # ------------------------------------------------------------------ 9
    phase(f"9 fused-loss kernels vs plain versions ({nb}, {HW}, {HW}, {NC}) "
          "bf16 logits, int64 labels")
    max_err = {k: 0.0 for k in names}
    bad = 0
    for label, cw in weights.items():
        stats = k89.dice_ce_stats(logits, labels, cw)
        want = k89.dice_ce_stats_reference(logits, labels, cw)
        exact = k89.dice_ce_stats_reference(logits.double(), labels, cw)
        coef = k89.loss_coefficients(want, torch.ones((), device=dev), NC,
                                     1.0, label == "uniform", cw)
        dx = k89.dice_ce_bwd(logits, labels, coef)
        dx_exact = k89.dice_ce_bwd_reference(logits.double(), labels, coef)
        torch.cuda.synchronize()
        rel = float(((stats.double() - exact.double()).abs()
                     / exact.double().abs().clamp_min(1e-30)).max())
        beyond, ulps = k9_within_ulp(dx, dx_exact)
        max_err["dice_ce_stats"] = max(max_err["dice_ce_stats"],
                                       float((stats - want).abs().max()))
        max_err["dice_ce_bwd"] = max(
            max_err["dice_ce_bwd"],
            float((dx.float() - k89.dice_ce_bwd_reference(
                logits, labels, coef).float()).abs().max()))
        print(f"{label}: K8 largest relative error vs float64 {rel:.3e} "
              f"(limit 1e-5); K9 elements beyond one bf16 ulp + floor "
              f"{beyond} of {dx.numel()}, largest error {ulps:.3f} ulp",
              flush=True)
        bad += (rel > 1e-5) + beyond
    if bad:
        raise RuntimeError("fused-loss kernel checks failed")

    # ------------------------------------------------------------------ 10
    phase(f"10 train: cli train --packed with OCTSEG_PACKED_FUSED_LOSS=1 "
          f"(f={F}, {NC} classes, {HW}x{HW}, batch {nb}), five steps")
    os.environ["OCTSEG_PACKED_FUSED_LOSS"] = "1"
    try:
        trainer, train_ds, val_ds = cli.build_training(train_cli_args())
        reset()
        trained = trainer.fit(train_ds, val_ds).model.state_dict()
        torch.cuda.synchronize()
        launches = counts()
    finally:
        del os.environ["OCTSEG_PACKED_FUSED_LOSS"]
    losses = [r["train_loss"] for r in trainer.history]
    print(f"train losses {[f'{v:.6f}' for v in losses]}; launches "
          f"{launches}, expected 5 x K8/K9 1/1 and "
          f"{LAUNCHES_PER_STEP['torch']}", flush=True)
    if len(losses) != 5 or not all(math.isfinite(v) for v in losses):
        raise RuntimeError(f"train losses {losses}")
    if not losses[4] < losses[0]:
        raise RuntimeError(f"loss did not go down: {losses}")
    want = {**{k: 5 * v for k, v in LAUNCHES_PER_STEP["torch"].items()},
            "dice_ce_stats": 5, "dice_ce_bwd": 5}
    if launches != want:
        raise RuntimeError(f"launch counts, expected {want}")
    del trainer, train_ds, val_ds
    torch.cuda.empty_cache()

    x8, y8 = batch(nb, SEED + 20)

    def step_grads(fused, x=x8):
        model = unet()
        model.load_state_dict(trained)
        out, _ = packed_unet.packed_unet_apply(model, x)
        loss = (k89.dice_ce_loss_fused if fused else dice_ce_loss)(out, y8)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: p.grad.detach().double()
                                      for n, p in model.named_parameters()}

    x_ulp = one_ulp_change(x8, dev)
    fused, unfused = step_grads(True), step_grads(False)
    agree = agreement(fused, unfused)
    floor = agreement(fused, step_grads(True, x_ulp))
    print(f"one step from the trained state, fused vs unfused loss: "
          f"{reading(agree)}; fused on a 1-ulp input change: "
          f"{reading(floor)}", flush=True)
    stats_fn, bwd_fn = k89.dice_ce_stats, k89.dice_ce_bwd

    def k9_drops_pixels(x, lab, coef):
        """K9 with every 64th pixel's dlogits left out."""
        dx = bwd_fn(x, lab, coef)
        dx.view(-1, dx.shape[-1])[::64] = 0
        return dx

    def k8_counts_high(x, lab, cw):
        """K8 with its per-class label counts 0.5% high (scaling every sum
        alike would leave the loss's ratios, and so the loss, as they
        are)."""
        stats = stats_fn(x, lab, cw)
        stats[2 * NC:3 * NC] *= 1.005
        return stats

    k9_drops_pixels.launches = k8_counts_high.launches = 0
    faults = {}
    for label, fault in (
        ("K9 leaves out every 64th pixel",
         swapped(k89, dice_ce_bwd=k9_drops_pixels)),
        ("K8 counts 0.5% high",
         swapped(k89, dice_ce_stats=k8_counts_high)),
    ):
        with fault:
            faults[label] = agreement(step_grads(True), unfused)
        print(f"planted fault, {label}: {reading(faults[label])}", flush=True)
    print(f"gate: relative loss < {FUSED_GATE['loss']}, cosine > "
          f"{FUSED_GATE['cosine']}, norm change < {FUSED_GATE['norm']}")
    if not gate_passes(agree, FUSED_GATE):
        raise RuntimeError("fused-loss step and unfused step disagree")
    seen = [k for k, a in faults.items() if not gate_passes(a, FUSED_GATE)]
    if len(seen) != len(faults):
        raise RuntimeError(f"the gate sees only the faults {seen}")
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 11
    phase(f"11 fused-loss times on {card}")
    cw = weights["uniform"]
    stats = k89.dice_ce_stats(logits, labels, cw)
    coef = k89.loss_coefficients(stats, torch.ones((), device=dev), NC, 1.0,
                                 True, cw)
    lab_bytes = labels.element_size() * P
    work = {"dice_ce_stats": (8 * P * NC, 2 * P * NC + lab_bytes + 4 * NC
                              + 4 * (3 * NC + 2)),
            "dice_ce_bwd": (16 * P * NC, 4 * P * NC + lab_bytes
                            + 4 * 3 * NC)}
    rows = {}
    for k, fn, plain in (
        ("dice_ce_stats", lambda: k89.dice_ce_stats(logits, labels, cw),
         lambda: k89.dice_ce_stats_reference(logits, labels, cw)),
        ("dice_ce_bwd", lambda: k89.dice_ce_bwd(logits, labels, coef),
         lambda: k89.dice_ce_bwd_reference(logits, labels, coef)),
    ):
        ms, pms = time_ms(fn), time_ms(plain, 3)
        b_ms, b_by = bound(*work[k], PEAK["fp32"])
        rows[k] = (ms, pms, b_ms, b_by)
        print(f"time b{nb} {k}: kernel {ms:.4f} ms "
              f"({work[k][1] / ms / 1e6:.0f} GB/s), plain {pms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)

    def fwd_bwd(fn):
        def run():
            x = logits.detach().requires_grad_()
            torch.autograd.grad(fn(x, labels), x)
        return run

    for label, fn in (("unfused dice_ce_loss", dice_ce_loss),
                      ("fused dice_ce_loss_fused", k89.dice_ce_loss_fused)):
        print(f"time b{nb} {label} forward + backward: "
              f"{time_ms(fwd_bwd(fn)):.4f} ms", flush=True)

    xs, ys = batch(nb, SEED + 30 + nb)

    def warm_step(fused):
        state = create_train_state(unet(), OptimConfig())
        step = packed_unet.make_packed_train_step(dice_ce_loss,
                                                  fused_loss=fused)
        for _ in range(2):
            step(state, xs, ys)
        return lambda: step(state, xs, ys)

    for fused in (False, True, True, False):
        step = warm_step(fused)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        print(f"train step (packed, {'fused' if fused else 'unfused'} loss) "
              f"batch {nb}: {ms:.3f} ms, {nb / ms * 1e3:.1f} B-scans/s",
              flush=True)
    profile_breakdown(warm_step(True), 3, f"fused-loss steps at batch {nb}",
                      {"K8 dice_ce_stats": "dice_ce_stats",
                       "K9 dice_ce_bwd": "dice_ce_bwd",
                       "K4 conv3x3_bf16": "conv3x3_bf16_fwd",
                       "K5 conv3x3_bf16_wgrad": "conv3x3_bf16_wgrad",
                       "K6 bn_pair_sums": "pair_sums"})
    del step, xs, ys
    torch.cuda.empty_cache()

    return [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": "; ".join(REPLACES[k]), "launches": launches[k],
        "max_abs_err": max_err[k], "ms": rows[k][0], "plain_ms": rows[k][1],
        "bound_ms": rows[k][2], "bound_by": rows[k][3],
        # no single PyTorch call computes Dice + CE (the unfused loss's
        # time is printed above)
        "library_ms": None,
    } for k in names]


def relaynet_phases(dev, card, time_ms, http_post):
    """Phases 12-15: ReLayNet's int8 serving path (K7, and K3 for the
    head). -> the K7 entry of the kernels line."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        relaynet_int8 as tr,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
        start_in_background,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.relaynet_psrp import (
        relaynet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.server import (
        ServingLoop,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv7x3_int8 as k7,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )

    rf = RELAYNET_F
    gen = np.random.default_rng(SEED + 60)

    def stage_args(h, cins, n):
        """Seeded signed int8 inputs (PReLU outputs are signed) and an
        epilogue that spreads the outputs over the int8 range."""
        xs = tuple(torch.tensor(gen.integers(-127, 128, (n, h, h, c)),
                                dtype=torch.int8, device=dev) for c in cins)
        w = torch.tensor(gen.integers(-127, 128, (rf, sum(cins), 7, 3)),
                         dtype=torch.int8, device=dev)
        std = (21 * sum(cins)) ** 0.5 * 73 * 73
        scale = torch.tensor(gen.uniform(30, 60, rf) / std,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, rf), dtype=torch.float32,
                            device=dev)
        return xs, k7.pack_conv7x3_weights(w), scale, bias, \
            float(gen.uniform(0.05, 1.0))

    # ------------------------------------------------------------------ 12
    phase(f"12 ReLayNet K7 vs its plain version (batch 2, every stage)")
    max_err, bad = 0, 0
    for name, h, cins, pool in relaynet_stages(rf, HW):
        args = stage_args(h, cins, 2)
        got = k7.conv7x3_int8(*args, pool=pool)
        want = k7.conv7x3_int8_reference(*args, pool=pool)
        torch.cuda.synchronize()
        got, want = (got, want) if pool else ((got,), (want,))
        mism = sum(int((a != b).sum()) for a, b in zip(got, want))
        max_err = max([max_err] + [int((a.int() - b.int()).abs().max())
                                   for a, b in zip(got, want)])
        print(f"{name:8s} {h:4d}^2 {str(cins):9s} -> {rf} pool={pool!s:5s} "
              f"outputs {[tuple(a.shape) for a in got]} mismatches {mism}",
              flush=True)
        bad += mism
    if bad:
        raise RuntimeError(f"{bad} K7 outputs differ from plain")

    # ------------------------------------------------------------------ 13
    phase(f"13 ReLayNet graph: f={rf}, {NC} classes, {HW}x{HW}, batch 8")
    model = cli.build_model("relaynet", num_classes=NC, seed=SEED,
                            device=dev)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        # random BN terms and PReLU slopes in [0.5, 1], 7x3 weights x0.75:
        # the labels then spread over all 10 classes; larger weights or
        # slopes nearer 0 leave the float graph's argmax so near ties that
        # int8 noise moves more than 5% of it (PERF.md section 4)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, lo_hi, normal in ((m.weight, (0.5, 1.5), False),
                                         (m.bias, (0, 0.1), True),
                                         (m.running_mean, (0, 0.1), True),
                                         (m.running_var, (0.5, 1.5), False)):
                    e = torch.empty(t.shape)
                    t.copy_(e.normal_(*lo_hi, generator=g) if normal
                            else e.uniform_(*lo_hi, generator=g))
            elif isinstance(m, torch.nn.PReLU):
                m.weight.copy_(torch.empty(1).uniform_(0.5, 1.0, generator=g))
            elif isinstance(m, torch.nn.Conv2d) and m.kernel_size == (7, 3):
                m.weight.mul_(RELAYNET_GAIN)
    t0 = time.time()
    forward, calib = cli.build_relaynet_psrp_forward(model, image_size=HW,
                                                     device=dev, seed=SEED)
    print(f"fold + calibrate (TF32 off) + quantize: {time.time() - t0:.1f} s")
    imgs = torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal((8, HW, HW, 1)),
        dtype=torch.float32, device=dev)
    with torch.inference_mode():
        x = preprocess(imgs)
        lab = relaynet_psrp_forward(calib["qparams"], x, NC)
        lab_plain = relaynet_psrp_forward(calib["qparams"], x, NC,
                                          reference=True)
        q8 = tr.quantize_relaynet(calib["layers"], calib["taps"])
        ref8 = tr.relaynet_int8_forward(q8, x).argmax(-1)
        ref32 = tr.relaynet_folded_forward(calib["layers"], x).argmax(-1)
    torch.cuda.synchronize()
    graph_mism = int((lab != lab_plain).sum())
    a8 = float((lab.long() == ref8).float().mean())
    a32 = float((lab.long() == ref32).float().mean())
    hist = torch.bincount(lab.flatten().long(), minlength=NC).tolist()
    print(f"labels {tuple(lab.shape)} {lab.dtype}, class histogram {hist}")
    print(f"kernel graph vs plain graph: {graph_mism} label mismatches")
    print(f"agreement vs all-int8 oracle {a8:.6f} (> 0.995), "
          f"vs float graph {a32:.6f} (> 0.95)", flush=True)
    if graph_mism or not (a8 > 0.995 and a32 > 0.95):
        raise RuntimeError("ReLayNet graph check failed")
    del lab_plain, ref8, ref32, x
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ 14
    phase("14 serve ReLayNet: ServingLoop (batch 8) + HTTP, 6 requests, "
          "2 clients")
    reqs = np.random.default_rng(SEED + 4).uniform(
        0, 255, (8, HW, HW, 1)).astype(np.float32)
    with torch.inference_mode():
        direct = forward(torch.from_numpy(reqs).to(dev)).cpu().numpy()
    posts = [reqs[i] for i in range(5)] + [reqs[5:8]]
    post_want = [direct[i] for i in range(5)] + [direct[5:8]]
    wrappers = {"conv7x3_int8": k7.conv7x3_int8,
                "head_argmax": k3.head_argmax}
    for w in wrappers.values():
        w.launches = 0
    loop = ServingLoop(forward, (HW, HW, 1), device=dev, batch_size=8,
                       max_wait_ms=5.0)
    loop.warmup()
    httpd, _ = start_in_background(loop, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    results, errors = {}, []

    def client(idx):
        try:
            for i in idx:
                results[i] = http_post(url, posts[i])
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(range(c, 6, 2),))
               for c in range(2)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    launches = {k: w.launches for k, w in wrappers.items()}
    if errors:
        raise RuntimeError(f"client errors: {errors!r}")
    ok = [np.array_equal(results[i], post_want[i]) for i in range(6)]
    n_fwd = loop.batches_run + 1  # + the warm-up batch
    print(f"{sum(ok)}/6 responses equal the direct forward; "
          f"{loop.batches_run} batches + 1 warm-up; launches {launches}, "
          f"expected {n_fwd} x {RELAYNET_LAUNCHES}", flush=True)
    if not all(ok):
        raise RuntimeError("served labels differ from the direct forward")
    if any(launches[k] != n_fwd * v for k, v in RELAYNET_LAUNCHES.items()):
        raise RuntimeError("launch counts do not match the ReLayNet graph")

    # ------------------------------------------------------------------ 15
    phase(f"15 ReLayNet times on {card} (batch 32)")
    n = 32
    total = [0.0, 0.0]
    bounds = {"operations": 0.0, "bytes": 0.0}
    by_row = {}
    for name, h, cins, pool in relaynet_stages(rf, HW):
        args = stage_args(h, cins, n)
        with torch.inference_mode():
            ms = time_ms(lambda: k7.conv7x3_int8(*args, pool=pool))
            pms = time_ms(lambda: k7.conv7x3_int8_reference(*args, pool=pool),
                          3)
        ops, nbytes = relaynet_work(h, cins, pool, n, rf)
        b_ms, b_by = bound(ops, nbytes, PEAK["int8"])
        total[0] += ms
        total[1] += pms
        bounds[b_by] += b_ms
        row = by_row.setdefault("B14" if name.startswith("b0") else "B13",
                                [0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, ms, pms, b_ms)):
            row[i] += v
        print(f"time b{n} {name:8s} K7 kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TOPS), plain {pms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by})", flush=True)
        del args
        torch.cuda.empty_cache()
    print(f"time b{n} K7 summed over the 7 stages: kernel {total[0]:.4f} ms, "
          f"plain {total[1]:.4f} ms, bound {sum(bounds.values()):.4f} ms "
          f"{bounds}")
    for row, (n_st, ms, pms, b_ms) in sorted(by_row.items()):
        print(f"time b{n} TPU kernel {row} ({n_st} launches per forward): "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms")
    xb = torch.tensor(np.random.default_rng(n).uniform(0, 255, (n, HW, HW, 1)),
                      dtype=torch.float32, device=dev)
    with torch.inference_mode():
        ms = time_ms(lambda: forward(xb))
    print(f"served ReLayNet forward (z-score + graph) batch {n}: {ms:.3f} ms, "
          f"{n / ms * 1e3:.1f} B-scans/s", flush=True)
    profile_breakdown(lambda: forward(xb), 3, f"the served forward, batch {n}",
                      {"K7 conv7x3_int8": "conv_kh3_int8",
                       "K3 head_argmax": "head_argmax"})
    del xb, forward, calib, model
    torch.cuda.empty_cache()
    return {
        "name": "conv7x3_int8", "route": "cuda",
        "source": SOURCES["conv7x3_int8"],
        "replaces": "; ".join(REPLACES["conv7x3_int8"]),
        "launches": launches["conv7x3_int8"], "max_abs_err": max_err,
        "ms": total[0], "plain_ms": total[1],
        "bound_ms": sum(bounds.values()),
        "bound_by": max(bounds, key=bounds.get),
        # no single PyTorch call computes an int8 conv with a PReLU requant
        "library_ms": None,
    }


def device_ms(fn, runs=20):
    """Device time per call of ``fn``, summed over the kernels it launches
    (``torch.profiler``): the event timings of a kernel of tens of
    microseconds carry its launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):  # a trace can come back without device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / runs / 1e3
    return float("nan")


def stem_work(h, c1, cout, n):
    """(int8 ops, bytes) of one K10 call at batch n, h x h: the image read
    once, both outputs written once."""
    return (2 * n * h * h * 9 * (c1 + c1 * cout),
            n * h * h + 9 * c1 * (1 + cout) + 8 * (c1 + cout)
            + n * h * h * cout * 1.25)


def infer_eval_phases(dev, card, time_ms, model, calib, by_row):
    """Phases 16-21: the fused stem (K10), the int8 pool (K11), the
    row-packed graph, ``cli infer`` and ``cli eval``. ``model`` and
    ``calib``: phase 3's U-Net and its PSRP build; ``by_row``: phase 5's
    times per TPU kernel. -> the K10 and K11 entries of the kernels line."""
    import os
    import tempfile
    from types import SimpleNamespace

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.packed import (
        LAUNCHES_PER_FORWARD as PACKED_LAUNCHES,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.packed import (
        unet_packed_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv7x3_int8 as k7,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
        SyntheticOCTConfig,
        SyntheticOCTDataset,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        Trainer,
    )

    wrappers = {"stem_conv_int8": k10.stem_conv_int8,
                "conv3x3_int8": k12.conv3x3_int8,
                "conv7x3_int8": k7.conv7x3_int8,
                "pool2x2_int8": k12.pool2x2_int8,
                "ct2x2_int8": k12.ct2x2_int8, "head_argmax": k3.head_argmax}

    def reset():
        for w in wrappers.values():
            w.launches = 0

    def counts(keys):
        return {k: wrappers[k].launches for k in keys}

    gen = np.random.default_rng(SEED + 70)

    def i8(shape, lo=-127, hi=128):
        return torch.tensor(gen.integers(lo, hi, shape), dtype=torch.int8,
                            device=dev)

    def vec(n, lo, hi):
        return torch.tensor(gen.uniform(lo, hi, n), dtype=torch.float32,
                            device=dev)

    def stem_args(n, h, w, c1, cout):
        """A seeded int8 image, weights, and epilogues that spread both
        requants over the int8 range; the stem biases reach 40, so a halo
        holding the stem of a zero-padded image would show."""
        x = i8((n, h, w, 1))
        w0 = k12.pack_conv3x3_weights(i8((c1, 1, 3, 3)))
        w1 = k12.pack_conv3x3_weights(i8((cout, c1, 3, 3)))
        std0, std1 = 3 * 73 * 73, (9 * c1) ** 0.5 * 64 * 73
        return (x, w0, vec(c1, 30, 60) / std0, vec(c1, -5, 40), w1,
                vec(cout, 30, 60) / std1, vec(cout, -5, 5))

    pool_shapes = [(HW // 4, 4 * F), (HW // 8, 8 * F)]  # the deep pools

    # ------------------------------------------------------------------ 16
    phase("16 K10 (fused stem) and K11 (int8 pool) vs plain versions")
    max_err = {"stem_conv_int8": 0, "pool2x2_int8": 0}
    bad = 0
    for n, h, w, c1 in ((2, HW, HW, F), (2, HW, HW, F // 2), (2, 80, 48, F)):
        args = stem_args(n, h, w, c1, c1)
        got = k10.stem_conv_int8(*args)
        want = k10.stem_conv_int8_reference(*args)
        torch.cuda.synchronize()
        mism = sum(int((a != b).sum()) for a, b in zip(got, want))
        max_err["stem_conv_int8"] = max(
            [max_err["stem_conv_int8"]] + [int((a.int() - b.int()).abs().max())
                                           for a, b in zip(got, want)])
        zero = float((got[0] == 0).float().mean())
        print(f"K10 ({n}, {h}, {w}) c1 {c1} -> {c1}: outputs "
              f"{[tuple(a.shape) for a in got]} mismatches {mism} "
              f"(zeros {zero:.3f})", flush=True)
        bad += mism
        del args, got, want
    for n, h, c in [(2, h, c) for h, c in pool_shapes] + [(2, 32, 24)]:
        x = i8((n, h, h, c), -128, 128)
        got, want = k12.pool2x2_int8(x), k12.pool2x2_int8_reference(x)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        max_err["pool2x2_int8"] = max(max_err["pool2x2_int8"], int(
            (got.int() - want.int()).abs().max()))
        print(f"K11 ({n}, {h}, {h}, {c}): mismatches {mism}", flush=True)
        bad += mism
    if bad:
        raise RuntimeError(f"{bad} K10/K11 outputs differ from plain")

    # ------------------------------------------------------------------ 17
    phase(f"17 PSRP graph with the fused stem (f={F}, {HW}x{HW}, batch 8)")
    imgs = torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal((8, HW, HW, 1)),
        dtype=torch.float32, device=dev)
    qp = calib["qparams"]
    with torch.inference_mode():
        x = preprocess(imgs)
        unfused = unet_psrp_forward(qp, x, NC, stem_fuse=False)
        reset()
        fused = unet_psrp_forward(qp, x, NC, stem_fuse=True)
        torch.cuda.synchronize()
        stem_launches = counts(FUSED_STEM_LAUNCHES)
        fused_plain = unet_psrp_forward(qp, x, NC, stem_fuse=True,
                                        reference=True)
    torch.cuda.synchronize()
    mism = int((fused != unfused).sum())
    mism_plain = int((fused != fused_plain).sum())
    print(f"fused-stem labels vs unfused: {mism} mismatches; vs its plain "
          f"graph: {mism_plain}; launches {stem_launches}, expected "
          f"{FUSED_STEM_LAUNCHES}", flush=True)
    if mism or mism_plain or stem_launches != FUSED_STEM_LAUNCHES:
        raise RuntimeError("fused-stem graph check failed")
    del fused_plain

    # ------------------------------------------------------------------ 18
    phase(f"18 packed graph (infer --quantize packed; f={F}, {HW}x{HW}, "
          "batch 8)")
    t0 = time.time()
    packed_fwd, pcal = cli.build_quantized_forward(
        model, "unet", "packed", image_size=HW, device=dev, seed=SEED)
    print(f"fold + calibrate + quantize: {time.time() - t0:.1f} s")
    pq = pcal["qparams"]
    with torch.inference_mode():
        reset()
        lab = unet_packed_forward(pq, x, NC)
        torch.cuda.synchronize()
        packed_launches = counts(PACKED_LAUNCHES)
        lab_plain = unet_packed_forward(pq, x, NC, reference=True)
        ref8 = tq.unet_int8_forward(
            tq.quantize_unet(pcal["layers"], pcal["taps"]), x).argmax(-1)
        ref32 = tq.folded_forward(pcal["layers"], x).argmax(-1)
    torch.cuda.synchronize()
    graph_mism = int((lab != lab_plain).sum())
    a8 = float((lab.long() == ref8).float().mean())
    a32 = float((lab.long() == ref32).float().mean())
    hist = torch.bincount(lab.flatten().long(), minlength=NC).tolist()
    print(f"labels {tuple(lab.shape)} {lab.dtype}, class histogram {hist}")
    print(f"kernel graph vs plain graph: {graph_mism} label mismatches; "
          f"agreement vs all-int8 oracle {a8:.6f} (> 0.995), vs float graph "
          f"{a32:.6f} (> 0.95); vs the PSRP graph "
          f"{float((lab == unfused).float().mean()):.6f}")
    print(f"launches {packed_launches}, expected {PACKED_LAUNCHES}",
          flush=True)
    if graph_mism or not (a8 > 0.995 and a32 > 0.95) \
            or packed_launches != PACKED_LAUNCHES:
        raise RuntimeError("packed graph check failed")
    del lab_plain, ref8, ref32, unfused, fused, lab
    torch.cuda.empty_cache()

    common = ["--image-size", str(HW), "--num-classes", str(NC),
              "--batch-size", str(INFER_BATCH), "--device", "cuda",
              "--seed", str(SEED)]
    with tempfile.TemporaryDirectory() as tmp:
        # -------------------------------------------------------------- 19
        phase(f"19 cli infer ({HW}x{HW}, {INFER_BATCH} B-scans)")
        art = os.path.join(tmp, "packed.npz")
        masks = {}
        for label, argv in (
            ("unet packed --save-quantized", ["--quantize", "packed",
                                              "--save-quantized", art]),
            ("unet packed --load-quantized", ["--quantize", "packed",
                                              "--load-quantized", art]),
            ("unet psrp", ["--quantize", "psrp"]),
            ("relaynet psrp", ["--model", "relaynet", "--quantize", "psrp"]),
        ):
            out = os.path.join(tmp, label.replace(" ", "_"))
            reset()
            t0 = time.perf_counter()
            cli.main(["infer", *common, "--out-dir", out, *argv])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            m = np.load(os.path.join(out, "masks.npy"), allow_pickle=False)
            launched = {k: v for k, v in counts(wrappers).items() if v}
            print(f"{label}: masks {m.shape} {m.dtype}, classes "
                  f"{np.bincount(m.ravel(), minlength=NC).tolist()}, "
                  f"{wall:.2f} s (model, calibration, data and forward), "
                  f"launches {launched}", flush=True)
            if m.shape != (INFER_BATCH, HW, HW) or m.min() < 0 \
                    or m.max() >= NC:
                raise RuntimeError(f"cli infer {label}: bad masks")
            masks[label] = m
        same = np.array_equal(masks["unet packed --save-quantized"],
                              masks["unet packed --load-quantized"])
        print(f"--save-quantized then --load-quantized: identical masks "
              f"{same}")
        if not same:
            raise RuntimeError("the quantized artifact changed the masks")

        # -------------------------------------------------------------- 20
        phase(f"20 cli eval --quantize psrp ({HW}x{HW}, --num-val 8)")
        # the labels and masks cli eval scores, kept to score them again on
        # the CPU
        seen = []
        evaluate = Trainer.evaluate

        def keeping(self, state, dataset, *a, predict_fn=None, **kw):
            def epoch(e):
                for images, labels in dataset.epoch(e):
                    seen.append([labels.cpu()])
                    yield images, labels

            def predict(st, images):
                p = predict_fn(st, images)
                seen[-1].append(p.cpu())
                return p

            return evaluate(self, state, SimpleNamespace(epoch=epoch), *a,
                            predict_fn=predict, **kw)

        argv = ["eval", *common[:4], "--batch-size", "8", *common[6:],
                "--quantize", "psrp", "--num-val", "8"]
        with swapped(Trainer, evaluate=keeping):
            m = cli.main(argv)
        cpu_trainer, _ = cli.build_eval_trainer(cli.parser().parse_args(
            ["eval", "--num-classes", str(NC), "--device", "cpu"]))
        t0 = time.perf_counter()
        cpu = cpu_trainer.evaluate(
            None, SimpleNamespace(epoch=lambda e: iter(
                [(p, lab_) for lab_, p in seen])),
            predict_fn=lambda s, p: p)
        cpu_s = time.perf_counter() - t0
        total = int(m["confusion"].sum())
        worst = max(float(np.nanmax(np.abs(np.asarray(m[k], np.float64)
                                           - np.asarray(cpu[k], np.float64))))
                    for k in m if k != "confusion")
        nan_same = all(np.array_equal(np.isnan(np.asarray(m[k], float)),
                                      np.isnan(np.asarray(cpu[k], float)))
                       for k in m)
        print(f"{len(seen)} batch(es) scored; confusion sum {total} (pixels "
              f"{8 * HW * HW}), equal to the CPU's "
              f"{np.array_equal(m['confusion'], cpu['confusion'])}; largest "
              f"metric difference from the CPU {worst:.3e} (limit 1e-4), "
              f"NaNs in the same places {nan_same}; CPU scoring "
              f"{cpu_s:.2f} s", flush=True)
        if total != 8 * HW * HW or not worst <= 1e-4 or not nan_same \
                or not np.array_equal(m["confusion"], cpu["confusion"]):
            raise RuntimeError("cli eval check failed")
        del cpu_trainer, seen

    # ------------------------------------------------------------------ 21
    phase(f"21 fused stem, int8 pool and the packed graph: times on {card}")
    n = 32
    l0, l1 = qp["blk0_conv0"], qp["blk0_conv1"]
    xq = i8((n, HW, HW, 1))
    k10_args = (xq, l0["w_k"], l0["scale"], l0["bias"], l1["w_k"],
                l1["scale"], l1["bias"])

    def two_launches():
        mid = k12.conv3x3_int8((xq,), l0["w_k"], l0["scale"], l0["bias"])
        return k12.conv3x3_int8((mid,), l1["w_k"], l1["scale"], l1["bias"],
                                pool=True)

    with torch.inference_mode():
        rows = {}
        for turn in ("K1 + K1", "K10", "K10", "K1 + K1"):
            fn = two_launches if turn == "K1 + K1" else \
                (lambda: k10.stem_conv_int8(*k10_args))
            rows.setdefault(turn, []).append(time_ms(fn))
        k10_ms = statistics.median(rows["K10"])
        k10_plain = time_ms(lambda: k10.stem_conv_int8_reference(*k10_args),
                            3)
        dev_k10 = device_ms(lambda: k10.stem_conv_int8(*k10_args))
        dev_two = device_ms(two_launches)
    k10_bound, k10_by = bound(*stem_work(HW, F, F, n), PEAK["int8"])
    print(f"time b{n} K10 stem+blk0_conv1+pool: kernel {rows['K10']} ms "
          f"(median {k10_ms:.4f}), K1 stem + K1 blk0_conv1 "
          f"{rows['K1 + K1']} ms, plain {k10_plain:.4f} ms, bound "
          f"{k10_bound:.4f} ms ({k10_by}); device time (profiler) K10 "
          f"{dev_k10:.4f} ms, K1 + K1 {dev_two:.4f} ms", flush=True)
    del xq, k10_args
    k11 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
           "operations": 0.0, "bytes": 0.0}
    for h, c in pool_shapes:
        xp = i8((n, h, h, c), -128, 128)
        with torch.inference_mode():
            ms = time_ms(lambda: k12.pool2x2_int8(xp))
            pms = time_ms(lambda: k12.pool2x2_int8_reference(xp), 3)
            lms = time_ms(lambda: xp.unflatten(1, (h // 2, 2)).unflatten(
                3, (h // 2, 2)).amax((2, 4)))
            dev_ms = device_ms(lambda: k12.pool2x2_int8(xp))
            dev_lib = device_ms(lambda: xp.unflatten(1, (h // 2, 2)).unflatten(
                3, (h // 2, 2)).amax((2, 4)))
        nbytes = n * h * h * c * 1.25
        b_ms, b_by = bound(3 * n * h * h * c / 4, nbytes, PEAK["int8"])
        for key, v in (("ms", ms), ("plain_ms", pms), ("library_ms", lms),
                       (b_by, b_ms)):
            k11[key] += v
        print(f"time b{n} K11 ({h}^2 x {c}): kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.0f} GB/s), plain {pms:.4f} ms, library "
              f"amax {lms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); device time "
              f"(profiler) kernel {dev_ms:.4f} ms "
              f"({nbytes / dev_ms / 1e6:.0f} GB/s), amax {dev_lib:.4f} ms",
              flush=True)
        del xp
    for row, src in (("B15a", "B1"), ("B15b", "B2"), ("B15c", "B7")):
        n_st, ms, pms, b_ms = by_row[src]
        print(f"time b32 TPU kernel {row} (packed graph, {n_st} launches "
              f"per forward, the shapes of {src}): kernel {ms:.4f} ms, plain "
              f"{pms:.4f} ms, bound {b_ms:.4f} ms")
    torch.cuda.empty_cache()

    def psrp_fwd(images, stem_fuse=False):
        return unet_psrp_forward(qp, preprocess(images), NC,
                                 stem_fuse=stem_fuse)

    graphs = (("packed", packed_fwd),
              ("psrp, fused stem off", psrp_fwd),
              ("psrp, fused stem on",
               lambda b: psrp_fwd(b, stem_fuse=True)))
    for nb in (32, 128):
        xb = torch.tensor(
            np.random.default_rng(nb).uniform(0, 255, (nb, HW, HW, 1)),
            dtype=torch.float32, device=dev)
        # in turns: packed, off, on, on, off, packed
        for label, fn in graphs + graphs[::-1]:
            with torch.inference_mode():
                ms = time_ms(lambda: fn(xb))
            print(f"forward ({label}, z-score + graph) batch {nb}: "
                  f"{ms:.3f} ms, {nb / ms * 1e3:.1f} B-scans/s", flush=True)
        del xb
        torch.cuda.empty_cache()
    args = cli.parser().parse_args(
        ["eval", "--image-size", str(HW), "--num-classes", str(NC),
         "--device", "cuda", "--quantize", "psrp"])
    trainer, state = cli.build_eval_trainer(args)
    ds = SyntheticOCTDataset(SyntheticOCTConfig(height=HW, width=HW,
                                                num_layers=NC - 2, seed=99),
                             8, 8, dev)

    def predict(_state, images):
        return psrp_fwd(images)

    for contour in (True, False, True):
        trainer.evaluate(state, ds, contour_metrics=contour,
                         predict_fn=predict)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            trainer.evaluate(state, ds, contour_metrics=contour,
                             predict_fn=predict)
        torch.cuda.synchronize()
        print(f"Trainer.evaluate, one batch of 8 (synthetic data, the psrp "
              f"graph, contour metrics {contour}): "
              f"{(time.perf_counter() - t0) / 3 * 1e3:.3f} ms", flush=True)
    del trainer, state, ds, packed_fwd, pcal
    torch.cuda.empty_cache()
    return [{
        "name": "stem_conv_int8", "route": "cuda",
        "source": SOURCES["stem_conv_int8"],
        "replaces": "; ".join(REPLACES["stem_conv_int8"]),
        "launches": stem_launches["stem_conv_int8"],
        "max_abs_err": max_err["stem_conv_int8"], "ms": k10_ms,
        "plain_ms": k10_plain, "bound_ms": k10_bound, "bound_by": k10_by,
        # no single PyTorch call computes two int8 convs with requants
        "library_ms": None,
    }, {
        "name": "pool2x2_int8", "route": "cuda",
        "source": SOURCES["pool2x2_int8"],
        "replaces": "; ".join(REPLACES["pool2x2_int8"]),
        "launches": packed_launches["pool2x2_int8"],
        "max_abs_err": max_err["pool2x2_int8"], "ms": k11["ms"],
        "plain_ms": k11["plain_ms"],
        "bound_ms": k11["operations"] + k11["bytes"],
        "bound_by": ("operations" if k11["operations"] >= k11["bytes"]
                     else "bytes"),
        "library_ms": k11["library_ms"],
    }]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.http_server import (
        start_in_background,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.server import (
        ServingLoop,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )

    dev = torch.device("cuda", 0)
    wrappers = {"conv3x3_int8": k12.conv3x3_int8, "ct2x2_int8": k12.ct2x2_int8,
                "head_argmax": k3.head_argmax}
    plains = {"conv3x3_int8": k12.conv3x3_int8_reference,
              "ct2x2_int8": k12.ct2x2_int8_reference,
              "head_argmax": k3.head_argmax_reference}

    # ------------------------------------------------------------------ 1
    phase("1 device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}")
    cc = torch.cuda.get_device_capability(0)
    if cc != (9, 0):
        raise RuntimeError(f"compute capability {cc}, the kernels are sm_90a")
    t0 = time.time()
    lib_path = _build.build()
    _build.lib()
    print(f"kernels built and loaded in {time.time() - t0:.1f} s: "
          f"{lib_path.name}", flush=True)

    gen = np.random.default_rng(SEED)

    def i8(shape, lo=-127, hi=128):
        return torch.tensor(gen.integers(lo, hi, shape), dtype=torch.int8,
                            device=dev)

    def stage_args(kernel, shape, n):
        """Seeded inputs of one stage at batch n (scale/bias keep the
        outputs spread over the int8 range)."""
        if kernel == "conv3x3_int8":
            h, cins, cout, pool = shape
            xs = tuple(i8((n, h, h, c), 0, 128) for c in cins)
            w = k12.pack_conv3x3_weights(i8((cout, sum(cins), 3, 3)))
            std = (9 * sum(cins)) ** 0.5 * 64 * 73
            kw = {"relu": True, "pool": pool}
            args = (xs, w)
        elif kernel == "ct2x2_int8":
            h, cin, cout = shape
            args = (i8((n, h, h, cin)),
                    k12.pack_ct2x2_weights(i8((cin, cout, 2, 2))))
            std, kw = cin ** 0.5 * 73 * 73, {}
        else:
            h, cin = shape
            x = i8((n, h, h, cin))
            x[0, 0] = 0  # a row of all-zero pixels: logits = bias
            cout = NC
            args = (x, k3.pack_head_weights(i8((NC, cin, 1, 1))))
            std, kw = cin ** 0.5 * 73 * 73, {}
        scale = torch.tensor(gen.uniform(30, 60, cout) / std,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, cout), dtype=torch.float32,
                            device=dev)
        if kernel == "head_argmax":
            bias[3] = bias[7] = 10.0  # the all-zero row ties 3 and 7
        return args + (scale, bias), kw

    # ------------------------------------------------------------------ 2
    phase("2 kernels vs plain versions (batch 2, every stage)")
    max_err = {k: 0 for k in wrappers}
    bad = 0
    for name, kernel, shape in stages():
        args, kw = stage_args(kernel, shape, 2)
        got = wrappers[kernel](*args, **kw)
        want = plains[kernel](*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        mism = sum(int((g != w).sum()) for g, w in zip(got, want))
        err = max(int((g.int() - w.int()).abs().max()) for g, w in
                  zip(got, want))
        max_err[kernel] = max(max_err[kernel], err)
        extra = ""
        if kernel == "head_argmax":
            tie = got[0][0, 0]
            extra = f", tie row labels {sorted(set(tie.tolist()))}"
            if not bool((tie == 3).all()):
                raise RuntimeError("head tie did not go to the lowest class")
        print(f"{name:16s} {kernel:13s} {str(shape):28s} outputs "
              f"{[tuple(g.shape) for g in got]} mismatches {mism}{extra}",
              flush=True)
        bad += mism
    if bad:
        raise RuntimeError(f"{bad} kernel outputs differ from plain")

    # ------------------------------------------------------------------ 3
    phase("3 graph: f=32, 10 classes, 512x512")
    model = cli.build_model(num_classes=NC, init_features=F, seed=SEED,
                            device=dev)
    g = torch.Generator().manual_seed(SEED + 1)
    with torch.no_grad():
        # random BN terms, and 3x3 weights x1.75 so that activations do not
        # vanish and the labels are not all one class (at x2 the argmax
        # sits so near ties that the int8 contract has no margin left)
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                for t, init in ((m.weight, lambda t: t.uniform_(0.5, 1.5, generator=g)),
                                (m.bias, lambda t: t.normal_(0, 0.1, generator=g)),
                                (m.running_mean, lambda t: t.normal_(0, 0.1, generator=g)),
                                (m.running_var, lambda t: t.uniform_(0.5, 1.5, generator=g))):
                    t.copy_(init(torch.empty(t.shape)))
            elif isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3):
                m.weight.mul_(1.75)
    t0 = time.time()
    forward, calib = cli.build_psrp_forward(model, image_size=HW, device=dev,
                                            seed=SEED)
    print(f"fold + calibrate (TF32 off) + quantize: {time.time() - t0:.1f} s")
    imgs = torch.tensor(
        np.random.default_rng(SEED + 2).standard_normal((8, HW, HW, 1)),
        dtype=torch.float32, device=dev,
    )
    with torch.inference_mode():
        x = preprocess(imgs)
        lab = unet_psrp_forward(calib["qparams"], x, NC)
        lab_plain = unet_psrp_forward(calib["qparams"], x, NC, reference=True)
        q8 = tq.quantize_unet(calib["layers"], calib["taps"])
        ref8 = tq.unet_int8_forward(q8, x).argmax(-1)
        ref32 = tq.folded_forward(calib["layers"], x).argmax(-1)
    torch.cuda.synchronize()
    graph_mism = int((lab != lab_plain).sum())
    a8 = float((lab.long() == ref8).float().mean())
    a32 = float((lab.long() == ref32).float().mean())
    hist = torch.bincount(lab.flatten().long(), minlength=NC).tolist()
    print(f"labels {tuple(lab.shape)} {lab.dtype}, class histogram {hist}")
    print(f"kernel graph vs plain graph: {graph_mism} label mismatches")
    print(f"agreement vs all-int8 oracle {a8:.6f} (> 0.995), "
          f"vs float graph {a32:.6f} (> 0.95)", flush=True)
    if graph_mism or not (a8 > 0.995 and a32 > 0.95):
        raise RuntimeError("graph check failed")

    # ------------------------------------------------------------------ 4
    phase("4 serve: ServingLoop (batch 8) + HTTP, 12 requests, 3 clients")
    reqs = np.random.default_rng(SEED + 3).uniform(
        0, 255, (15, HW, HW, 1)
    ).astype(np.float32)
    with torch.inference_mode():
        direct = forward(torch.from_numpy(reqs).to(dev)).cpu().numpy()
    # 12 POSTs: 11 single B-scans and one batched request of 4
    posts = [reqs[i] for i in range(11)] + [reqs[11:15]]
    post_want = [direct[i] for i in range(11)] + [direct[11:15]]
    for k in wrappers.values():
        k.launches = 0
    loop = ServingLoop(forward, (HW, HW, 1), device=dev, batch_size=8,
                       max_wait_ms=5.0)
    loop.warmup()
    httpd, _ = start_in_background(loop, port=0)
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def post(arr):
        return http_post(url, arr)

    results: dict[int, np.ndarray] = {}
    errors: list[BaseException] = []

    def client(idx):
        try:
            for i in idx:
                results[i] = post(posts[i])
        except BaseException as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(range(c, 12, 3),))
               for c in range(3)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        # serve latency: one request at a time, warm
        lat = []
        for i in range(12):
            t0 = time.perf_counter()
            post(reqs[i % 15])
            lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        httpd.shutdown()
        httpd.server_close()
        loop.close()
    launches = {k: w.launches for k, w in wrappers.items()}
    if errors:
        raise RuntimeError(f"client errors: {errors!r}")
    ok = [np.array_equal(results[i], post_want[i]) for i in range(12)]
    n_fwd = loop.batches_run + 1  # + the warm-up batch
    print(f"healthz {health}")
    print(f"{sum(ok)}/12 responses equal the direct forward; "
          f"{loop.batches_run} batches + 1 warm-up")
    print(f"launches {launches}, expected {n_fwd} x "
          f"{LAUNCHES_PER_FORWARD}", flush=True)
    if not all(ok):
        raise RuntimeError("served labels differ from the direct forward")
    if any(launches[k] != n_fwd * v for k, v in LAUNCHES_PER_FORWARD.items()):
        raise RuntimeError("launch counts do not match the graph")

    # ------------------------------------------------------------------ 5
    phase(f"5 times on {card}")

    def time_ms(fn, runs=10):
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        out = []
        for _ in range(runs):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            fn()
            e1.record()
            e1.synchronize()
            out.append(e0.elapsed_time(e1))
        return statistics.median(out)

    totals = {k: [0.0, 0.0] for k in wrappers}
    bounds = {k: {"operations": 0.0, "bytes": 0.0} for k in wrappers}
    by_row = {}  # TPU kernel id -> [stages, kernel ms, plain ms, bound ms]
    for name, kernel, shape in stages():
        args, kw = stage_args(kernel, shape, 32)
        with torch.inference_mode():
            ms = time_ms(lambda: wrappers[kernel](*args, **kw))
            pms = time_ms(lambda: plains[kernel](*args, **kw))
        totals[kernel][0] += ms
        totals[kernel][1] += pms
        b_ms, b_by = bound(*serving_work(kernel, shape, 32), PEAK["int8"])
        bounds[kernel][b_by] += b_ms
        row = by_row.setdefault(tpu_row(name, kernel, shape),
                                [0, 0.0, 0.0, 0.0])
        for i, v in enumerate((1, ms, pms, b_ms)):
            row[i] += v
        print(f"time b32 {name:16s} {kernel:13s} kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        del args
        torch.cuda.empty_cache()
    for k, (ms, pms) in totals.items():
        print(f"time b32 {k} summed over the graph's stages: kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms, bound "
              f"{sum(bounds[k].values()):.4f} ms {bounds[k]}")
    for row, (n_stages, ms, pms, b_ms) in sorted(by_row.items()):
        print(f"time b32 TPU kernel {row} ({n_stages} launches per forward): "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {b_ms:.4f} ms")
    for n in (32, 128):
        xb = torch.tensor(
            np.random.default_rng(n).uniform(0, 255, (n, HW, HW, 1)),
            dtype=torch.float32, device=dev,
        )
        with torch.inference_mode():
            ms = time_ms(lambda: forward(xb))
        print(f"served forward (z-score + graph) batch {n}: {ms:.3f} ms, "
              f"{n / ms * 1e3:.1f} B-scans/s", flush=True)
        del xb
        torch.cuda.empty_cache()
    print(f"serve latency, one B-scan per request (HTTP, batch-8 loop): "
          f"median {statistics.median(lat):.2f} ms, min {min(lat):.2f} ms")

    kernels = [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": "; ".join(REPLACES[k]), "launches": launches[k],
        "max_abs_err": max_err[k], "ms": totals[k][0],
        "plain_ms": totals[k][1],
        "bound_ms": sum(bounds[k].values()),
        "bound_by": max(bounds[k], key=bounds[k].get),
        # no single PyTorch call computes an int8 conv with requant (K1),
        # an int8 transposed conv with requant (K2) or head + argmax on
        # int8 (K3)
        "library_ms": None,
    } for k in wrappers]
    kernels += train_phases(dev, card, time_ms)
    k89 = fused_loss_phases(dev, card, time_ms)
    kernels += [relaynet_phases(dev, card, time_ms, http_post)] + k89
    kernels += infer_eval_phases(dev, card, time_ms, model, calib, by_row)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
