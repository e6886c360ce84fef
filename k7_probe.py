#!/usr/bin/env python3
"""Where K7's time goes on the card: ReLayNet's int8 7x3 conv
(``csrc/conv7x3_int8.cu``) built as it is and with parts of its work taken
out, timed at the seven stage shapes of the served forward (f=64, 512x512,
batch 32).

    python3 k7_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc, into a temporary directory with its own copy
of ``csrc/mma_int8.cuh``):
- ``kernel``: the source as it is (checked bit-equal to the plain version at
  each stage, batch 2);
- ``no_copies``: every cp.async reads no byte and zero-fills its chunk (the
  ring, the gathers, the barriers and the products stay);
- ``no_products``: the K chunks' ldmatrix and mma.sync are skipped (the
  copies, barriers and the epilogue stay);
- ``no_epilogue``: the requant, the shared-memory tile and the stores of y,
  the pooled values and the indices are skipped.

Prints the card's name and power limit, then per stage and build the device
time (``torch.profiler``, mean of 20 calls).
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

STAGES = [  # (name, H, cins, pool) at f=64, as chip_smoke.relaynet_stages
    ("b0 stem", 512, (1,), True), ("b1", 256, (64,), True),
    ("b2", 128, (64,), True), ("b3", 64, (64,), False),
    ("b4", 128, (64, 64), False), ("b5", 256, (64, 64), False),
    ("b6", 512, (64, 64), False)]
COPY16 = '"r"(ok ? 16 : 0)'  # csrc/mma_int8.cuh: cp_async16
COPY4 = '"r"(ok ? 4 : 0)'    # K7's cp_async4
PRODUCTS = {"        mma_chunk<MW, KH, 3, NT, PITCH>(":
            "        if (cout < 0) mma_chunk<MW, KH, 3, NT, PITCH>(",
            "        for (int kc = 0; kc < NK; ++kc) {":
            "        for (int kc = 0; kc < NK * (cout < 0); ++kc) {"}
EPILOGUES = ["    epilogue<MW, NT>(", "    epilogue<SMW, NT>("]


def builds(src: str, header: str) -> dict[str, tuple[str, str]]:
    """name -> (K7's source, the shared header csrc/mma_int8.cuh)."""
    edits = [(header, COPY16), (src, COPY4)] + [
        (src, line) for line in list(PRODUCTS) + EPILOGUES]
    for text, line in edits:
        if text.count(line) != 1:
            raise RuntimeError("k7_probe: the K7 sources no longer have the "
                               f"line this probe edits: {line!r}")
    no_products, no_epilogue = src, src
    # a run-time condition that never holds: the code stays compiled
    for line, skipped in PRODUCTS.items():
        no_products = no_products.replace(line, skipped)
    for line in EPILOGUES:
        no_epilogue = no_epilogue.replace(
            line, line.replace("epilogue", "if (cout < 0) epilogue"))
    return {"kernel": (src, header),
            "no_copies": (src.replace(COPY4, '"r"(0)'),
                          header.replace(COPY16, '"r"(0)')),
            "no_products": (no_products, header),
            "no_epilogue": (no_epilogue, header)}


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv7x3_int8 as k7,
    )

    if not torch.cuda.is_available():
        print("k7_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "conv7x3_int8.cu").read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, (text, hdr) in builds(src, header).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "mma_int8.cuh").write_text(hdr)
            cu, so = d / "conv7x3_int8.cu", d / "k7.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            fn = ctypes.CDLL(str(so)).octseg_conv7x3_int8
            fn.argtypes = _build.SIGNATURES["octseg_conv7x3_int8"]
            fn.restype = ctypes.c_int
            fns[name] = fn

    dev = torch.device("cuda")
    gen = np.random.default_rng(0)

    def args(h, cins, n):
        xs = tuple(torch.tensor(gen.integers(-127, 128, (n, h, h, c)),
                                dtype=torch.int8, device=dev) for c in cins)
        w = k7.pack_conv7x3_weights(torch.tensor(
            gen.integers(-127, 128, (64, sum(cins), 7, 3)), dtype=torch.int8,
            device=dev))
        std = (21 * sum(cins)) ** 0.5 * 73 * 73
        scale = torch.tensor(gen.uniform(30, 60, 64) / std,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, 64), dtype=torch.float32,
                            device=dev)
        return xs, w, scale, bias, 0.25

    def call(fn, xs, w, scale, bias, alpha, pool):
        N, H, W, _ = xs[0].shape
        plan = k7.conv7x3_plan(N, H, W, tuple(x.shape[-1] for x in xs), 64,
                               7, pool)
        y = torch.empty((N, H, W, 64), dtype=torch.int8, device=dev)
        yp, yi = (torch.empty((N, H // 2, W // 2, 64), dtype=torch.int8,
                              device=dev) for _ in range(2))
        x1 = xs[1].data_ptr() if len(xs) > 1 else None
        _build.check(fn(
            xs[0].data_ptr(), plan.cin0, x1, plan.cin1, w.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), alpha, y.data_ptr(),
            yp.data_ptr() if pool else None, yi.data_ptr() if pool else None,
            N, H, W, 64, plan.coutp, 7, plan.co_t, plan.nk, plan.stages,
            plan.blocks,
            k7.LOADERS.index(plan.loader), plan.smem,
            torch.cuda.current_stream().cuda_stream), "K7 probe")
        return (y, yp, yi) if pool else (y,)

    def device_ms(run, runs=20):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / runs / 1e3

    for name, h, cins, pool in STAGES:
        a = args(h, cins, 2)
        got = call(fns["kernel"], *a, pool)
        want = k7.conv7x3_int8_reference(*a, pool=pool)
        want = want if pool else (want,)
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise RuntimeError(f"K7 differs from its plain version at {name}")
        a = args(h, cins, 32)
        times = {b: device_ms(lambda: call(fn, *a, pool))
                 for b, fn in fns.items()}
        print(f"{name:8s} {h}^2 {cins} batch 32: " + ", ".join(
            f"{b} {t:.4f} ms" for b, t in times.items()), flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
