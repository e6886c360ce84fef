#!/usr/bin/env python3
"""Where K5's time goes on the card: the bf16 weight-gradient kernel
(``csrc/conv3x3_bf16.cu``) built as it is and with parts of its work taken
out, timed at the default train step's three K5 shapes and a deep one.

    python3 k5_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc, into a temporary directory):
- ``kernel``: the source as it is (checked bit-equal to the plain version on
  integer inputs);
- ``no_copies``: every cp.async reads no byte and zero-fills its chunk
  (the ring, its barriers and the products stay);
- ``no_products``: the 16-pixel steps of mma.sync and ldmatrix are skipped
  (the copies, barriers and partials stay);
- ``neither``: both taken out.

Prints the card's name and power limit, then per shape and build the device
time of each of K5's two kernels (``torch.profiler``, mean of 20 calls).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

SHAPES = [  # (N, H, W, cin, cout): blk0_conv1, blk8_conv0, blk8_conv1, blk4_conv1
    (8, 512, 512, 32, 32), (8, 512, 512, 64, 32), (8, 512, 512, 32, 32),
    (8, 32, 32, 512, 512),
]
COPY = '"r"(ok ? 16 : 0)'
STEPS = "            for (int k = 0; k < nk; ++k) {"


def builds(src: str) -> dict[str, str]:
    if COPY not in src or STEPS not in src:
        raise RuntimeError("k5_probe: the K5 source no longer has the lines "
                           "this probe edits")
    no_copies = src.replace(COPY, '"r"(0)')
    no_products = src.replace(STEPS, STEPS.replace("k < nk", "k < 0 * nk"))
    return {"kernel": src, "no_copies": no_copies, "no_products": no_products,
            "neither": no_products.replace(COPY, '"r"(0)')}


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_bf16 as k45,
    )

    if not torch.cuda.is_available():
        print("k5_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "conv3x3_bf16.cu").read_text()
    fns = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, text in builds(src).items():
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            fn = ctypes.CDLL(str(so)).octseg_conv3x3_bf16_wgrad
            fn.argtypes = _build.SIGNATURES["octseg_conv3x3_bf16_wgrad"]
            fn.restype = ctypes.c_int
            fns[name] = fn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def call(fn, x, dy, plan):
        partial = torch.empty((plan.G, 9, plan.n_ci * plan.ci_t,
                               plan.n_co * plan.co_t), device=dev)
        dw = torch.empty((3, 3, plan.cin, plan.cout), device=dev)
        _build.check(fn(x.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                        dw.data_ptr(), *x.shape, plan.cout, plan.G, plan.R,
                        plan.twk, plan.ci_t,
                        torch.cuda.current_stream().cuda_stream), "K5 probe")
        return dw

    def device_ms(run, runs=20):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                name = re.search(r"conv3x3_bf16_wgrad_\w+(<\d+>)?", e.key)
                key = name.group(0) if name else e.key[:40]
                out[key] = out.get(key, 0.0) + \
                    e.self_device_time_total / runs / 1e3
        return out

    for n, h, w, cin, cout in SHAPES:
        plan = k45.wgrad_plan(n, h, w, cin, cout)
        xi = torch.randint(-2, 3, (n, h, w, cin), generator=g,
                           device=dev).bfloat16()
        di = torch.randint(-2, 3, (n, h, w, cout), generator=g,
                           device=dev).bfloat16()
        if not torch.equal(call(fns["kernel"], xi, di, plan),
                           k45.conv3x3_bf16_wgrad_reference(xi, di)):
            raise RuntimeError(f"K5 differs from its plain version at {plan}")
        x = torch.randn((n, h, w, cin), generator=g, device=dev).bfloat16()
        dy = torch.randn((n, h, w, cout), generator=g, device=dev).bfloat16()
        for name, fn in fns.items():
            times = device_ms(lambda: call(fn, x, dy, plan))
            parts = ", ".join(f"{k} {v:.4f}" for k, v in times.items())
            print(f"{n}x{h}x{w} {cin}->{cout} {name:11s} device "
                  f"{sum(times.values()):.4f} ms ({parts}) G={plan.G} "
                  f"R={plan.R} twk={plan.twk} ci_t={plan.ci_t}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
