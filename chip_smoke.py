#!/usr/bin/env python3
"""Drive the PyTorch port's int8 U-Net serving path once on one NVIDIA GPU.

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
   at batch 32, the served forward at batch 32 and 128, serve latency.

The last lines are a JSON object with the kernels, then
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import io
import json
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

F, NC, HW = 32, 10, 512
SEED = 0

# TPU kernels each port kernel replaces (JAX package, file:line of the def)
_JAX = "retinal_oct_image_segmentation_via_deep_learning_tpu/ops/"
REPLACES = {
    "conv3x3_int8": [_JAX + "pallas_conv_psrp.py:442 conv3x3_psrp",
                     _JAX + "pallas_conv_psrp.py:777 stem_psrp",
                     _JAX + "pallas_conv_int8.py:204 conv3x3_int8"],
    "ct2x2_int8": [_JAX + "pallas_conv_int8.py:323 ct2x2_int8",
                   _JAX + "pallas_conv_psrp.py:603 ct_up_psrp",
                   _JAX + "pallas_conv_psrp.py:676 ct_psrp"],
    "head_argmax": [_JAX + "pallas_conv_psrp.py:1074 head_argmax_psrp"],
}
_PKG = "retinal_oct_image_segmentation_via_deep_learning_tpu_torch/"
SOURCES = {"conv3x3_int8": _PKG + "csrc/conv3x3_int8.cu",
           "ct2x2_int8": _PKG + "csrc/ct2x2_int8.cu",
           "head_argmax": _PKG + "csrc/head_argmax.cu"}
LAUNCHES_PER_FORWARD = {"conv3x3_int8": 18, "ct2x2_int8": 4,
                        "head_argmax": 1}


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


def phase(name):
    print(f"\n=== {name} ===", flush=True)


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
        buf = io.BytesIO()
        np.save(buf, arr)
        req = urllib.request.Request(f"{url}/predict", data=buf.getvalue(),
                                     method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return np.load(io.BytesIO(r.read()), allow_pickle=False)

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
    for name, kernel, shape in stages():
        args, kw = stage_args(kernel, shape, 32)
        with torch.inference_mode():
            ms = time_ms(lambda: wrappers[kernel](*args, **kw))
            pms = time_ms(lambda: plains[kernel](*args, **kw))
        totals[kernel][0] += ms
        totals[kernel][1] += pms
        print(f"time b32 {name:16s} {kernel:13s} kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms", flush=True)
        del args
        torch.cuda.empty_cache()
    for k, (ms, pms) in totals.items():
        print(f"time b32 {k} summed over the graph's stages: kernel "
              f"{ms:.4f} ms, plain {pms:.4f} ms")
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

    # ------------------------------------------------------------------ 6
    kernels = [{
        "name": k, "route": "cuda", "source": SOURCES[k],
        "replaces": "; ".join(REPLACES[k]), "launches": launches[k],
        "max_abs_err": max_err[k], "ms": totals[k][0],
        "plain_ms": totals[k][1],
    } for k in wrappers]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
