#!/usr/bin/env python3
"""Where K4's time goes on the card: the bf16 3x3 training conv's mma.sync
body (``csrc/conv3x3_bf16.cu:conv3x3_bf16_mma``) built as it is and with
parts of its work taken out, timed at the default train step's six K4
calls (f=32, 512x512, batch 8), beside the WMMA body and a 64-wide block;
then both bodies at the other 14 convs of the U-Net (the
``mid=deep="kernel"`` step), forward and dgrad.

    python3 k4_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc, into a temporary directory):
- ``kernel``: the source as it is (checked bit-equal to the plain version
  on integer inputs at each of the six calls, batch 2);
- ``no_copies``: every cp.async reads no byte and zero-fills its chunk (the
  ring, its barriers, the products and the epilogue stay);
- ``no_products``: the K chunks' ldmatrix and mma.sync are skipped (the
  copies, barriers and the epilogue stay);
- ``no_epilogue``: the bf16 tile and the stores of y are skipped.

Prints the card's name and power limit, then per call and build the device
time (``torch.profiler``, mean of 20 calls; the weights are packed once,
outside the timed calls), and the sums over the six calls.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

# the six K4 calls of the default step: (name, N, H, cin, cout)
CALLS = [("fwd blk0_conv1", 8, 512, 32, 32), ("fwd blk8_conv0", 8, 512, 64, 32),
         ("fwd blk8_conv1", 8, 512, 32, 32), ("dgrad blk0_conv1", 8, 512, 32, 32),
         ("dgrad blk8_conv0", 8, 512, 32, 64), ("dgrad blk8_conv1", 8, 512, 32, 32)]
F = 32
COPY = '"r"(ok ? 16 : 0)'
PRODUCTS = "        mma_chunk<MW, NT, PITCH>("
EPILOGUE = "    epilogue<NT>(acc, k4_smem"


def deep_calls(f=F, hw=512, n=8):
    """The other 14 convs of the U-Net (chip_smoke.train_convs), forward
    and dgrad: (name, N, H, cin, cout)."""
    convs, h, c = [], hw // 2, f
    for i in range(1, 5):
        convs += [(f"blk{i}_conv0", h, c, 2 * c), (f"blk{i}_conv1", h, 2 * c, 2 * c)]
        h, c = h // 2, 2 * c
    for blk, h, c in ((5, hw // 8, 8 * f), (6, hw // 4, 4 * f), (7, hw // 2, 2 * f)):
        convs += [(f"blk{blk}_conv0", h, 2 * c, c), (f"blk{blk}_conv1", h, c, c)]
    return [(f"{kind} {name}", n, h, a, b) for name, h, cin, cout in convs
            for kind, a, b in (("fwd", cin, cout), ("dgrad", cout, cin))]


def builds(src: str) -> dict[str, str]:
    for line in (COPY, PRODUCTS, EPILOGUE):
        if src.count(line) != 1:
            raise RuntimeError("k4_probe: the K4 source no longer has the "
                               f"line this probe edits: {line!r}")
    # a run-time condition that never holds: the code stays compiled
    return {"kernel": src, "no_copies": src.replace(COPY, '"r"(0)'),
            "no_products": src.replace(PRODUCTS, "        if (cout < 0) "
                                       + PRODUCTS.lstrip()),
            "no_epilogue": src.replace(EPILOGUE, "    if (cout < 0) "
                                       + EPILOGUE.lstrip())}


def main() -> int:
    import numpy as np
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
        print("k4_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "conv3x3_bf16.cu").read_text()
    libs = {}
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
            lib = ctypes.CDLL(str(so))
            for entry in ("octseg_conv3x3_bf16_mma", "octseg_conv3x3_bf16"):
                fn = getattr(lib, entry)
                fn.argtypes = _build.SIGNATURES[entry]
                fn.restype = ctypes.c_int
            libs[name] = lib

    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def args(n, h, cin, cout, integers):
        def t(shape):
            v = gen.integers(-2, 3, shape) if integers else \
                gen.standard_normal(shape)
            return torch.tensor(v, dtype=torch.bfloat16, device=dev)
        return t((n, h, h, cin)), t((3, 3, cin, cout))

    def runner(lib, x, w, plan):
        """One launch of ``plan``'s body from ``lib``, weights packed once."""
        N, H, W, cin = x.shape
        cout = w.shape[-1]
        y = torch.empty((N, H, W, cout), dtype=torch.bfloat16, device=dev)
        if plan.body == "mma":
            wk = k45.pack_conv3x3_bf16_weights(w, plan.co_t)

            def run():
                _build.check(lib.octseg_conv3x3_bf16_mma(
                    x.data_ptr(), wk.data_ptr(), y.data_ptr(), N, H, W, cin,
                    cout, plan.coutp, plan.co_t, plan.nk, plan.stages,
                    plan.smem, stream), "K4 probe")
                return y
        else:
            def run():
                _build.check(lib.octseg_conv3x3_bf16(
                    x.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, cin,
                    cout, stream), "K4 probe")
                return y
        return run

    def device_ms(run, runs=20):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                run()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / runs / 1e3

    def plans(n, h, cin, cout):
        return {"mma32": k45.plan_for(n, h, h, cin, cout, "mma", 32),
                "mma64": k45.plan_for(n, h, h, cin, cout, "mma", 64),
                "wmma": k45.plan_for(n, h, h, cin, cout, "wmma")}

    sums: dict[str, float] = {}
    for name, n, h, cin, cout in CALLS:
        x, w = args(2, h, cin, cout, True)
        want = k45.conv3x3_bf16_reference(x, w)
        for label, plan in plans(2, h, cin, cout).items():
            got = runner(libs["kernel"], x, w, plan)()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K4 {label} differs from its plain "
                                   f"version at {name}")
        x, w = args(n, h, cin, cout, False)
        times = {}
        for label, plan in plans(n, h, cin, cout).items():
            times[label] = device_ms(runner(libs["kernel"], x, w, plan))
        p32 = plans(n, h, cin, cout)["mma32"]
        for b in ("no_copies", "no_products", "no_epilogue"):
            times[b] = device_ms(runner(libs[b], x, w, p32))
        for k, v in times.items():
            sums[k] = sums.get(k, 0.0) + v
        print(f"{name:16s} {h}^2 {cin}->{cout} batch {n}: " + ", ".join(
            f"{b} {t:.4f} ms" for b, t in times.items()), flush=True)
        del x, w
        torch.cuda.empty_cache()
    print("six calls summed: " + ", ".join(f"{b} {t:.4f} ms"
                                           for b, t in sums.items()))
    for name, n, h, cin, cout in deep_calls():
        x, w = args(n, h, cin, cout, False)
        times = {label: device_ms(runner(libs["kernel"], x, w, plan))
                 for label, plan in plans(n, h, cin, cout).items()}
        print(f"{name:16s} {h}^2 {cin}->{cout} batch {n}: " + ", ".join(
            f"{b} {t:.4f} ms" for b, t in times.items()), flush=True)
        del x, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
