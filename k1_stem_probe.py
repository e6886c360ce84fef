#!/usr/bin/env python3
"""Where K1's stem time goes on the card: the served U-Net's Cin=1 int8 3x3
conv on its stem body (``csrc/conv3x3_int8.cu:conv3x3_int8_stem``) built
as it is and with parts of its work taken out, timed at the served
forward's stem (512x512, batch 32, cout 32; cout 16 and 64 for the
unmodified build).

    python3 k1_stem_probe.py            # from the repository root; one card
    python3 k1_stem_probe.py --wrapper  # the public entry points alone

Builds (each by its own nvcc, into a temporary directory with its own copy
of ``csrc/mma_int8.cuh``; the unmodified one and ``blocks5`` with
``-Xptxas -v``, whose register and spill lines for the stem kernels are
printed):
- ``kernel``: the source as it is (checked bit-equal to the plain version
  at batch 2 before anything is timed, as is ``exact_float``);
- ``no_copies``: every cp.async of the halo reads no byte and zero-fills
  its unit (the buffers, the barriers, the products and the epilogue
  stay);
- ``no_products``: the mma.sync products are skipped (the accumulators
  stay 0; the A words, the requant and the stores stay);
- ``no_requant``: the FMA and the rounding are skipped (each
  accumulator's low byte is stored);
- ``no_stores``: the stores to device memory are skipped (the requant
  stays: its words, folded by XOR, decide a store that never happens);
- ``skeleton``: both of the last two (the loop, its shared-memory reads,
  shifts, products and packing alone);
- ``exact_float``: float(acc) by an integer add to the bits of 1.5 * 2^23
  and a float subtraction instead of the conversion instruction;
- ``st128`` (cout 32): lanes t and t^1 swap one pixel's words, so each
  lane stores 16 bytes of one pixel (half the store instructions, two
  shuffles more);
- ``unroll1``: one 16-pixel tile an iteration of the row loop (the
  source takes two);
- ``blocks5``: five resident blocks an SM (``__launch_bounds__``; the
  grid five blocks an SM).

Prints the card's name and power limit, then the device time
(``torch.profiler``: each kernel's mean recorded duration over three
windows of 10 calls; weights packed once, outside the timed calls) of
each build at the plan's launch, of the unmodified build with one block
a tile (``one_tile``: the grid is the tiles, not the persistent grid), of
K1's dp4a body at the same call, and of ``zero_()`` on a tensor of the
output's shape: the card's reachable rate for the same bytes of writes,
a yardstick, not the stem's function. Each time comes with its share of
the bound (the input read once and the output written once at 3.35 TB/s)
and its GB/s.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

HBM = 3.35e12
COPY = '"r"(ok ? 16 : 0)'  # csrc/mma_int8.cuh: cp_async16
PRODUCTS = "                mma_s8(acc[j], a, b[j], 0u);"
CONVERT = "__int2float_rn(acc[j][2 * h + e])"
REQUANT = """                        r[i] = rounded_bits(
                            __fmaf_rn(__int2float_rn(acc[j][2 * h + e]), sc[i], bi[i]),
                            lo, out_clip);"""
STORES = "                int8_t* o = out + (size_t)(x0 + 8 * h) * COUT;"
LOOP = "#pragma unroll 2\n        for (int x0 = 0; x0 < W; x0 += 16) {"
H_LOOP = "channel CPL * t + 2j + e\n#pragma unroll\n"
STORE8 = """                } else if constexpr (CPL == 8) {
                    *reinterpret_cast<uint2*>(o) = make_uint2(pack4(r), pack4(r + 4));"""
# lanes t and t^1 swap one pixel's words: even t stores pixel g, odd t
# pixel g + 8, 16 bytes each
SWAP8 = """                } else if constexpr (CPL == 8) {
                    wd[h][0] = pack4(r);
                    wd[h][1] = pack4(r + 4);
                    if (h == 1) {
                        const bool odd = t & 1;
                        const uint32_t s0 = __shfl_xor_sync(
                            0xffffffffu, odd ? wd[0][0] : wd[1][0], 1);
                        const uint32_t s1 = __shfl_xor_sync(
                            0xffffffffu, odd ? wd[0][1] : wd[1][1], 1);
                        int8_t* q = out + (size_t)(x0 + 8 * odd) * COUT - CPL * odd;
                        *reinterpret_cast<uint4*>(q) =
                            odd ? make_uint4(s0, s1, wd[1][0], wd[1][1])
                                : make_uint4(wd[0][0], wd[0][1], s0, s1);
                    }"""
BOUNDS = "NT == 8 ? 2 : 4) conv3x3_int8_stem("


def builds(src: str, header: str) -> dict[str, tuple[str, str]]:
    """name -> (K1's source, the shared header)."""
    for text, line in ((header, COPY), (src, PRODUCTS), (src, CONVERT),
                       (src, REQUANT), (src, STORES), (src, LOOP),
                       (src, H_LOOP), (src, STORE8), (src, BOUNDS)):
        if text.count(line) != 1:
            raise RuntimeError("k1_stem_probe: the K1 sources no longer have "
                               f"the line this probe edits: {line!r}")
    no_requant = src.replace(REQUANT, "                        r[i] = "
                             "acc[j][2 * h + e];")
    # the requant's words, folded by XOR, decide a store that never
    # happens, so the compiler keeps the requant
    skip = (STORES + "\n                { uint32_t k = 0; for (int i = 0; "
            "i < CPL; ++i) k ^= r[i]; if (k != 0x1234567u) continue; }")
    # run-time conditions that never hold: the code stays compiled
    return {
        "kernel": (src, header),
        "no_copies": (src, header.replace(COPY, '"r"(0)')),
        "no_products": (src.replace(PRODUCTS, "                if (W < 0) "
                                    + PRODUCTS.lstrip()), header),
        "no_requant": (no_requant, header),
        "no_stores": (src.replace(STORES, skip), header),
        "skeleton": (no_requant.replace(STORES, skip), header),
        "st128": (src.replace(H_LOOP, H_LOOP.replace(
            "#", "            uint32_t wd[2][2];\n#")).replace(STORE8, SWAP8),
                  header),
        "unroll1": (src.replace(LOOP, LOOP.replace(" 2\n", " 1\n")), header),
        "blocks5": (src.replace(BOUNDS, BOUNDS.replace(": 4)", ": 5)")),
                    header),
        "exact_float": (src.replace(CONVERT, "__fsub_rn(__int_as_float("
                                    "0x4B400000 + acc[j][2 * h + e]), "
                                    "12582912.0f)"), header),
    }


def ptxas_lines(out: str) -> list[str]:
    """ptxas's lines for the stem kernels' entry functions."""
    keep, entry = [], ""
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "conv3x3_int8_stem" in entry and (
                "Compiling entry" in line or "Used" in line
                or "spill" in line):
            keep.append(line.strip())
    return keep


def device_ms(fn, runs=10):
    """Device time a call of ``fn``: each kernel's mean recorded duration
    over three windows of ``runs`` calls, times its launches a call."""
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
    """``--wrapper``: K1's wrapper on the served stem (512x512, batch 32,
    cout 32; the stem weights packed once where the checkout has a stem
    pack) and the served U-Net forward (f=32, 10 classes, seeded random
    weights, z-score and graph) at batch 32 and 128, CUDA-event median of
    10 and device time, in the checkout the script runs from. Run from two
    checkouts in one call on the card, it compares them."""
    import statistics

    import numpy as np
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )

    if not torch.cuda.is_available():
        print("k1_stem_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    print(card(), flush=True)
    dev = torch.device("cuda")
    gen = np.random.default_rng(0)

    def event_ms(fn, runs=10):
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

    x = torch.tensor(gen.integers(-127, 128, (32, 512, 512, 1)),
                     dtype=torch.int8, device=dev)
    wq = torch.tensor(gen.integers(-127, 128, (32, 1, 3, 3)),
                      dtype=torch.int8, device=dev)
    scale = torch.tensor(gen.uniform(30, 60, 32) / (3 * 73 ** 2),
                         dtype=torch.float32, device=dev)
    bias = torch.tensor(gen.uniform(-5, 5, 32), dtype=torch.float32,
                        device=dev)
    kw = ({"w_mma": k12.pack_stem_mma_weights(wq)}
          if hasattr(k12, "pack_stem_mma_weights") else {})
    wk = k12.pack_conv3x3_weights(wq)

    def stem():
        return k12.conv3x3_int8((x,), wk, scale, bias, **kw)

    print(f"wrapper stem (32, 512, 512, 1) -> 32: event {event_ms(stem):.4f}"
          f" ms, device {device_ms(stem):.4f} ms", flush=True)
    del x
    model = cli.build_model(num_classes=10, init_features=32, seed=0,
                            device=dev)
    forward, _ = cli.build_psrp_forward(model, image_size=512, device=dev,
                                        seed=0)
    for n in (32, 128):
        xb = torch.tensor(
            np.random.default_rng(n).uniform(0, 255, (n, 512, 512, 1)),
            dtype=torch.float32, device=dev)
        with torch.inference_mode():
            ms = event_ms(lambda: forward(xb))
        print(f"wrapper served forward batch {n}: {ms:.3f} ms", flush=True)
        del xb
        torch.cuda.empty_cache()
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
        print("k1_stem_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    print(card(), flush=True)
    src = (_build.CSRC / "conv3x3_int8.cu").read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, (text, hdr) in builds(src, header).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "mma_int8.cuh").write_text(hdr)
            cu, so = d / "conv3x3_int8.cu", d / "k1.so"
            cu.write_text(text)
            verbose = (["-Xptxas", "-v"] if name in ("kernel", "blocks5")
                       else [])
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, *verbose, "-shared",
                 "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            if name in ("kernel", "blocks5"):
                print(f"ptxas, {name}:\n" + "\n".join(ptxas_lines(out)),
                      flush=True)
            lib = ctypes.CDLL(str(so))
            for fn in ("octseg_conv3x3_int8_stem", "octseg_conv3x3_int8"):
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def args(n, h, cout):
        x = torch.tensor(gen.integers(-127, 128, (n, h, h, 1)),
                         dtype=torch.int8, device=dev)
        wq = torch.tensor(gen.integers(-127, 128, (cout, 1, 3, 3)),
                          dtype=torch.int8, device=dev)
        scale = torch.tensor(gen.uniform(30, 60, cout) / (3 * 73 ** 2),
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, cout), dtype=torch.float32,
                            device=dev)
        y = torch.empty((n, h, h, cout), dtype=torch.int8, device=dev)
        return x, wq, scale, bias, y

    def stem(lib, x, wq, scale, bias, y, plan):
        """One launch of the stem body at ``plan`` from ``lib``."""
        N, H, W, _ = x.shape
        wm = k12.pack_stem_mma_weights(wq)

        def run():
            _build.check(lib.octseg_conv3x3_int8_stem(
                x.data_ptr(), wm.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), N, H, W, plan.cout, 1, 0,
                127.0, plan.grid, plan.smem, stream), "K1 stem probe")
            return y
        return run

    def dp4a(lib, x, wq, scale, bias, y):
        """One launch of K1's dp4a body on the same call."""
        N, H, W, _ = x.shape
        wk = k12.pack_conv3x3_weights(wq)

        def run():
            _build.check(lib.octseg_conv3x3_int8(
                x.data_ptr(), 1, None, 0, wk.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), None, N, H, W, 4,
                scale.shape[0], wk.shape[2], 1, 0, 0, 127.0, 1.0, 0.0, 127.0,
                None, None, None, 0, None, stream), "K1 dp4a probe")
            return y
        return run

    for cout in (16, 32, 64):
        a = args(2, 512, cout)
        want = k12.conv3x3_int8_reference((a[0],), k12.pack_conv3x3_weights(
            a[1]), a[2], a[3])
        plan = k12.conv3x3_plan(2, 512, 512, (1,), cout, sms=sms)
        for name in ("kernel", "exact_float", "st128", "unroll1", "blocks5"):
            for p in (plan, plan._replace(grid=plan.units)):
                got = stem(libs[name], *a, p)()
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise RuntimeError(f"the stem body ({name}, grid "
                                       f"{p.grid}) differs from its plain "
                                       f"version at cout {cout}")
        del a
    print("bit-equal at batch 2, 512^2, cout 16, 32 and 64: kernel, "
          "exact_float, st128, unroll1 and blocks5, persistent and one tile "
          "a block", flush=True)

    n, h = 32, 512
    for cout in (32, 16, 64):
        a = args(n, h, cout)
        plan = k12.conv3x3_plan(n, h, h, (1,), cout, sms=sms)
        nbytes = n * h * h * (cout + 1) + 16 * cout + 8 * cout
        bound = nbytes / HBM * 1e3
        times = {"kernel": device_ms(stem(libs["kernel"], *a, plan))}
        if cout == 32:
            for b in ("no_copies", "no_products", "no_requant", "no_stores",
                      "skeleton", "exact_float", "st128", "unroll1"):
                times[b] = device_ms(stem(libs[b], *a, plan))
            times["blocks5"] = device_ms(stem(libs["blocks5"], *a, plan._replace(
                grid=min(plan.units, 5 * sms))))
        times["one_tile"] = device_ms(stem(libs["kernel"], *a,
                                           plan._replace(grid=plan.units)))
        times["dp4a body"] = device_ms(dp4a(libs["kernel"], *a))
        z = a[4]
        times["zero_ (yardstick)"] = device_ms(lambda: z.zero_())
        times["kernel again"] = device_ms(stem(libs["kernel"], *a, plan))
        print(f"stem {h}^2 x 1 -> {cout}, batch {n} (grid {plan.grid}, "
              f"{plan.blocks_per_sm} blocks an SM, smem {plan.smem}; bound "
              f"{bound:.4f} ms, bytes): " + ", ".join(
                  f"{b} {t:.4f} ms ({100 * bound / t:.1f}%, "
                  f"{nbytes / t / 1e6:.0f} GB/s)" for b, t in times.items()),
              flush=True)
        del a, z
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(wrapper_times() if sys.argv[1:] == ["--wrapper"] else main())
