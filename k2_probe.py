#!/usr/bin/env python3
"""Where K2's time goes on the card: the served U-Net's int8 2x2 transposed
conv on its tensor-core body (``csrc/ct2x2_int8.cu:ct2x2_int8_mma``) built
as it is and with parts of its work taken out, timed at the four calls of
the served forward (ct0-ct3; f=32, 512x512, batch 32).

    python3 k2_probe.py             # from the repository root; one card
    python3 k2_probe.py --wrapper   # K2's wrapper alone (see wrapper_times)

Builds (each by its own nvcc, into a temporary directory with its own copy
of ``csrc/mma_int8.cuh``; the unmodified one with ``-Xptxas -v``, whose
register and spill lines for the kernel are printed):
- ``kernel``: the source as it is (checked bit-equal to the plain version
  at each call and each launch below, batch 2, before anything is timed);
- ``no_copies``: every cp.async reads no byte and zero-fills its unit (the
  ring, the barriers, the products and the epilogue stay);
- ``no_products``: the K chunks' ldmatrix and mma.sync are skipped (the
  copies, barriers and the epilogue stay);
- ``no_epilogue``: the requant, the shared-memory tile and the stores are
  skipped;
- ``no_requant``: the requant and the writes of the shared-memory tile
  are skipped (the tile's stale bytes are stored);
- ``no_stores``: the 16-byte stores of the tile to device memory are
  skipped (the requant and the tile stay).

Prints the card's name and power limit, then per call the device time
(``torch.profiler``: each kernel's mean recorded duration over three
windows of 10 calls; weights packed once, outside the timed calls) of each
build at the plan's launch, of the unmodified build at one tile a block
(``one_tile``: the grid is the tiles, not the persistent grid) and at the
other channel tiles that fit (``co16`` .. ``co128``), and with the w4a4
knobs at ct0/ct1 (per-column bias, clip 7, +-7 values); then the sums over
the four calls. As a yardstick, not K2's function (no requant, no
scatter to the output phases, an int32 output four times the bytes), the
device time of ``torch._int_mm`` on the same (M, cin) x (cin, 4 cout)
GEMM; the port never calls it.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

F = 32
COPY = '"r"(ok ? 16 : 0)'  # csrc/mma_int8.cuh: cp_async16
PRODUCTS = "            mma_chunk(acc, ring"
EPILOGUE = "        epilogue<WM, WN>(acc, os"
REQUANT = "    for (int t = 0; t < NT; ++t) {\n        const int n = wn * 64"
STORES = "            if (m0 + p < M && co0 + c < cout) {"


def calls(f=F, hw=512, n=32):
    """The four K2 calls of the served forward: (name, N, H, cin, cout),
    as chip_smoke.stages lists them."""
    h, c = hw // 16, 16 * f
    out = []
    for k in range(4):
        out.append((f"ct{k}", n, h, c, c // 2))
        h, c = 2 * h, c // 2
    return out


def builds(src: str, header: str) -> dict[str, tuple[str, str]]:
    """name -> (K2's source, the shared header)."""
    for text, line in ((header, COPY), (src, PRODUCTS), (src, EPILOGUE),
                       (src, REQUANT), (src, STORES)):
        if text.count(line) != 1:
            raise RuntimeError("k2_probe: the K2 sources no longer have the "
                               f"line this probe edits: {line!r}")
    # a run-time condition that never holds: the code stays compiled
    return {"kernel": (src, header),
            "no_copies": (src, header.replace(COPY, '"r"(0)')),
            "no_products": (src.replace(PRODUCTS, "        if (cout < 0) "
                                        + PRODUCTS.lstrip()), header),
            "no_epilogue": (src.replace(EPILOGUE, "        if (cout < 0) "
                                        + EPILOGUE.lstrip()), header),
            "no_requant": (src.replace(REQUANT, REQUANT.replace(
                "t < NT;", "t < NT * (cout < 0);")), header),
            "no_stores": (src.replace(STORES, STORES.replace(
                "< cout)", "< cout && cout < 0)")), header)}


def ptxas_lines(out: str) -> list[str]:
    """ptxas's lines for the kernel's entry functions."""
    keep, entry = [], ""
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "ct2x2_int8_mma" in entry and (
                "Compiling entry" in line or "Used" in line
                or "spill" in line):
            keep.append(line.strip())
    return keep


def device_ms(fn, runs=10):
    """Device time a call of ``fn``: each kernel's mean recorded duration
    over three windows of ``runs`` calls, times its launches a call (the
    profiler drops events late in a process; those it keeps carry their
    full durations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kernels = {}  # name -> [us, events, most in a window]
    for _window in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or not e.count:
                continue
            k = kernels.setdefault(e.key, [0.0, 0, 0])
            k[0] += e.self_device_time_total
            k[1] += e.count
            k[2] = max(k[2], e.count)
    if not kernels:
        return float("nan")
    return sum(us / count * math.ceil(most / runs)
               for us, count, most in kernels.values()) / 1e3


def card() -> str:
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return smi.stdout.strip()


def wrapper_times() -> int:
    """``--wrapper``: K2 through its public wrapper (``pack_ct2x2_weights``,
    then ``ct2x2_int8``) at the four calls, CUDA-event and device time, in
    the checkout the script runs from. Run from two checkouts in one call
    on the card, it compares their K2 call by call."""
    import statistics

    import numpy as np
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )

    if not torch.cuda.is_available():
        print("k2_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(card(), flush=True)
    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    total = [0.0, 0.0]
    for name, n, h, cin, cout in calls():
        x = torch.tensor(gen.integers(-127, 128, (n, h, h, cin)),
                         dtype=torch.int8, device=dev)
        wp = k12.pack_ct2x2_weights(torch.tensor(
            gen.integers(-127, 128, (cin, cout, 2, 2)), dtype=torch.int8,
            device=dev))
        scale = torch.tensor(gen.uniform(30, 60, cout) / cin ** 0.5 / 73 ** 2,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-3, 3, cout), dtype=torch.float32,
                            device=dev)

        def call():
            return k12.ct2x2_int8(x, wp, scale, bias)

        events = []
        for _ in range(12):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            events.append(e0.elapsed_time(e1))
        ms, dms = statistics.median(events[2:]), device_ms(call)
        total[0] += ms
        total[1] += dms
        print(f"wrapper {name}: event {ms:.4f} ms, device {dms:.4f} ms",
              flush=True)
        del x, wp
        torch.cuda.empty_cache()
    print(f"wrapper four calls: event {total[0]:.4f} ms, device "
          f"{total[1]:.4f} ms")
    return 0


def main() -> int:
    import numpy as np
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )

    if not torch.cuda.is_available():
        print("k2_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    print(card(), flush=True)
    src = (_build.CSRC / "ct2x2_int8.cu").read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, (text, hdr) in builds(src, header).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "mma_int8.cuh").write_text(hdr)
            cu, so = d / "ct2x2_int8.cu", d / "k2.so"
            cu.write_text(text)
            verbose = ["-Xptxas", "-v"] if name == "kernel" else []
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *verbose, "-shared",
                 "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            if name == "kernel":
                print("\n".join(ptxas_lines(out)), flush=True)
            lib = ctypes.CDLL(str(so))
            lib.octseg_ct2x2_int8.argtypes = _build.SIGNATURES[
                "octseg_ct2x2_int8"]
            lib.octseg_ct2x2_int8.restype = ctypes.c_int
            libs[name] = lib

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def args(n, h, cin, cout, four=False):
        lo, hi = (-7, 8) if four else (-127, 128)
        x = torch.tensor(gen.integers(lo, hi, (n, h, h, cin)),
                         dtype=torch.int8, device=dev)
        wq = torch.tensor(gen.integers(lo, hi, (cin, cout, 2, 2)),
                          dtype=torch.int8, device=dev)
        std = cin ** 0.5 * (16 if four else 73 ** 2)
        scale = torch.tensor(gen.uniform(30, 60, cout) / std / (10 if four
                                                                else 1),
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-3, 3, 4 * cout if four else cout),
                            dtype=torch.float32, device=dev)
        return x, k12.pack_ct2x2_weights(wq), scale, bias, \
            7.0 if four else 127.0

    def runner(lib, x, wp, scale, bias, clip, plan):
        """One launch of ``plan`` from ``lib``."""
        N, H, W, cin = x.shape
        cout = scale.shape[0]
        y = torch.empty((N, 2 * H, 2 * W, cout), dtype=torch.int8,
                        device=dev)
        per_col = int(bias.numel() == 4 * cout)

        def run():
            _build.check(lib.octseg_ct2x2_int8(
                x.data_ptr(), wp.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), per_col, clip, y.data_ptr(), N, H, W, cin,
                cout, plan.tm, plan.co_t, plan.nk, plan.stages, plan.grid,
                int(plan.loader == "gather"), plan.smem, stream), "K2 probe")
            return y
        return run

    def launches(n, h, cin, cout):
        """The plan's launch (first), one tile a block, and the other
        channel tiles whose weights fit."""
        plan = k12.ct2x2_plan(n, h, h, cin, cout, True, sms)
        out = {"plan": plan,
               "one_tile": k12.ct2x2_plan_for(n, h, h, cin, cout, plan.co_t,
                                              True, sms, persistent=False)}
        for _, co_t in k12.CT_TILES:
            other = k12.ct2x2_plan_for(n, h, h, cin, cout, co_t, True, sms)
            if co_t != plan.co_t and other.tm and co_t <= max(16, cout):
                out[f"co{co_t}"] = other
        return out

    for name, n, h, cin, cout in calls():
        for four in (False, True) if name in ("ct0", "ct1") else (False,):
            a = args(2, h, cin, cout, four)
            want = k12.ct2x2_int8_reference(*a[:4], out_clip=a[4])
            for label, plan in launches(2, h, cin, cout).items():
                got = runner(libs["kernel"], *a, plan)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"K2 {label} differs from its plain "
                                       f"version at {name}")
            del a
    print("bit-equal at batch 2: every call and launch", flush=True)

    sums: dict[str, float] = {}
    for name, n, h, cin, cout in calls():
        a = args(n, h, cin, cout)
        ls = launches(n, h, cin, cout)
        plan = ls["plan"]
        times = {label: device_ms(runner(libs["kernel"], *a, p))
                 for label, p in ls.items()}
        for b in ("no_copies", "no_products", "no_epilogue", "no_requant",
                  "no_stores"):
            times[b] = device_ms(runner(libs[b], *a, plan))
        if name in ("ct0", "ct1"):
            a4 = args(n, h, cin, cout, True)
            times["w4a4"] = device_ms(runner(libs["kernel"], *a4, plan))
            del a4
        M = n * h * h
        xm = a[0].view(M, cin)
        wd = k12.unpack_ct2x2_weights(a[1], cin).permute(0, 2, 3, 1) \
            .reshape(cin, 4 * cout)
        wd = wd.t().contiguous().t()  # column-major
        try:
            times["torch._int_mm (not K2's function)"] = device_ms(
                lambda: torch._int_mm(xm, wd))
        except RuntimeError as err:  # a yardstick only: report and go on
            print(f"torch._int_mm at {name}: not measured ({err})")
        for k, v in times.items():
            sums[k] = sums.get(k, 0.0) + v
        print(f"{name} {h}^2 x {cin} -> {2 * h}^2 x {cout}, batch {n} (plan "
              f"{plan.tm} pixels x {plan.co_t} channels, grid {plan.grid} x "
              f"{plan.n_co}, {plan.blocks_per_sm} blocks an SM, smem "
              f"{plan.smem}): " + ", ".join(
                  f"{b} {t:.4f} ms" for b, t in times.items()), flush=True)
        del a, xm, wd
        torch.cuda.empty_cache()
    print("four calls summed: " + ", ".join(
        f"{b} {t:.4f} ms" for b, t in sums.items()
        if not b.startswith("co") and b != "w4a4"))
    return 0


if __name__ == "__main__":
    sys.exit(wrapper_times() if sys.argv[1:] == ["--wrapper"] else main())
