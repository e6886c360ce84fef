#!/usr/bin/env python3
"""Where K10's time goes on the card: the served U-Net's fused stem (stem
conv, blk0_conv1 and its pool, f=32) on its mma.sync body
(``csrc/stem_conv_int8.cu:stem_conv_int8_mma``) built as it is and with
parts of its work taken out, timed at the served forward's call (512x512,
batch 32), beside the dp4a body and K1's two launches.

    python3 k10_probe.py            # from the repository root; one card
    python3 k10_probe.py --wrapper  # the public entry points alone

Builds (each by its own nvcc, into a temporary directory with its own copy
of ``csrc/mma_int8.cuh``; the unmodified one with ``-Xptxas -v``, whose
register, spill and shared-memory lines for the mma.sync body are
printed):
- ``kernel``: the source as it is (checked bit-equal to the plain version
  at batch 2, 512^2, and at (3, 14, 48) before anything is timed);
- ``no_copies``: every cp.async of the image rows reads no byte and
  zero-fills its 16 bytes (conv1's weights still arrive);
- ``no_stem_products``: the stem's mma.sync products are skipped (the A
  words, the requant and the ring stores stay);
- ``no_stem_requant``: the stem's requant and its 8-byte stores into the
  ring are skipped (each accumulator's low byte is packed; the words,
  folded by XOR, decide a store that never happens);
- ``no_products``: conv1's ldmatrix reads and products are skipped (the
  accumulators stay 0);
- ``no_epilogue``: conv1's requant is skipped (each accumulator's low byte
  is packed; the pool and the stores stay);
- ``no_stores``: the 8-byte stores of the output and the pooled output
  are skipped (their words decide a store that never happens);
- ``vmaxu4``: the pool's byte max by ``__vmaxu4`` instead of the source's
  ``max_bytes`` (checked bit-equal too);
- ``stem_unroll2``: the stem's loop over a row's 16-pixel products
  unrolled twice;
- ``blocks1``: one resident block an SM (``__launch_bounds__``: up to 255
  registers, no spills), timed at one block an SM beside the source at
  the same launch.

Prints the card's name and power limit, then the device time
(``torch.profiler``: each kernel's mean recorded duration over three
windows of 10 calls, times its launches a call; weights packed once,
outside the timed calls) of each build at the plan's launch, of the
unmodified build at other bands (output rows a unit) and with one block
an SM, of the dp4a body (its own entry point), of K1's stem and
blk0_conv1 (the package's wrapper, two launches), and of ``zero_()`` on
tensors of the outputs' shapes (the card's rate for the same bytes of
writes, a yardstick, not K10's function); each with its share of the
bound (the larger of the image read once and both outputs written once
at 3.35 TB/s, and the int8 operations at 1979 TOPS).
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

HBM, INT8 = 3.35e12, 1979e12
COPY = ("                    cp_async16(base + dst, img + ((size_t)n * H + iy)"
        " * W + 16 * c, true);")
STEM_PRODUCTS = "                            mma_s8(acc[j], a, b0[j], 0u);"
STEM_REQUANT = """                                    v[i8] = rounded_bits(
                                        __fmaf_rn(__int2float_rn(acc[j][2 * h + e]), sc[i8], bi[i8]),
                                        0.0f, 127.0f);"""
STEM_STORES = """#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        *reinterpret_cast<uint2*>(row + swz(16 * c + g + 8 * h + 1, t >> 1)) = out[h];"""
PRODUCTS = "            ring_products(acc, rc, a_col, base + w1_off, b_off);"
REQUANT = """                            v[i8] = rounded_bits(
                                __fmaf_rn(__int2float_rn(acc[m][j][2 * h + e]), sc[i8], bi[i8]),
                                0.0f, 127.0f);"""
Y_STORE = "                *reinterpret_cast<uint2*>(yc + m * rs) = o[m][0];"
P_STORE = ("                *reinterpret_cast<uint2*>(po + c * (M_COLS / 2) * CH"
           " + (m / 2) * (rs / 2)) =")
MAX_BYTES = "= max_bytes("
STEM_LOOP = ("                for (int c = warp; c < gw; c += M_WARPS) {\n"
             "                    uint2 out[2]")
BOUNDS = "__launch_bounds__(M_THREADS, 2) stem_conv_int8_mma("
NEVER = "0x1234567u"  # a value the folded words are taken never to equal


def builds(src: str) -> dict[str, str]:
    """name -> K10's source with one part of the mma.sync body's work
    taken out (run-time conditions that never hold keep the code
    compiled)."""
    for line, count in ((COPY, 1), (STEM_PRODUCTS, 1), (STEM_REQUANT, 1),
                        (STEM_STORES, 1), (PRODUCTS, 1), (REQUANT, 1),
                        (Y_STORE, 1), (P_STORE, 1), (MAX_BYTES, 4),
                        (STEM_LOOP, 1), (BOUNDS, 1)):
        if src.count(line) != count:
            raise RuntimeError("k10_probe: the K10 source no longer has the "
                               f"line this probe edits: {line!r}")
    return {
        "kernel": src,
        "no_copies": src.replace(COPY, COPY.replace("true);", "false);")),
        "no_stem_products": src.replace(
            STEM_PRODUCTS, "                            if (W < 0) "
            + STEM_PRODUCTS.lstrip()),
        "no_stem_requant": src.replace(
            STEM_REQUANT, "                                    v[i8] = "
            "acc[j][2 * h + e];").replace(
            STEM_STORES, "                    if ((out[0].x ^ out[0].y ^ out[1].x "
            f"^ out[1].y) == {NEVER}) {{\n" + STEM_STORES
            + "\n                    }"),
        "no_products": src.replace(PRODUCTS, "            if (W < 0) "
                                   + PRODUCTS.lstrip()),
        "no_epilogue": src.replace(REQUANT, "                            "
                                   "v[i8] = acc[m][j][2 * h + e];"),
        "no_stores": src.replace(
            Y_STORE, "                if ((o[m][0].x ^ o[m][0].y ^ o[m][1].x "
            f"^ o[m][1].y) != {NEVER}) continue;\n" + Y_STORE).replace(
            P_STORE, "                if ((mx[0][0] ^ mx[0][1] ^ mx[1][0] ^ "
            f"mx[1][1]) != {NEVER}) continue;\n" + P_STORE),
        "vmaxu4": src.replace(MAX_BYTES, "= __vmaxu4("),
        "stem_unroll2": src.replace(STEM_LOOP, "#pragma unroll 2\n"
                                    + STEM_LOOP),
        "blocks1": src.replace(BOUNDS, BOUNDS.replace(", 2)", ", 1)")),
    }


def ptxas_lines(out: str) -> list[str]:
    """ptxas's lines for the mma.sync body's entry function."""
    keep, entry = [], ""
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "stem_conv_int8_mma" in entry and (
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


def case(dev, gen, n, h, w):
    """Seeded int8 image, weights (K1's packs, the tensor-core packs) and
    epilogues of one f=32 fused-stem call; both requants spread over the
    int8 range, stem biases up to 40."""
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )

    def i8(shape):
        return torch.tensor(gen.integers(-127, 128, shape), dtype=torch.int8,
                            device=dev)

    def vec(lo, hi):
        return torch.tensor(gen.uniform(lo, hi, 32), dtype=torch.float32,
                            device=dev)

    x, w0, w1 = i8((n, h, w, 1)), i8((32, 1, 3, 3)), i8((32, 32, 3, 3))
    std0, std1 = 3 * 73 * 73, (9 * 32) ** 0.5 * 64 * 73
    return {"x": x, "w0": w0, "w1": w1,
            "wk": (k12.pack_conv3x3_weights(w0),
                   k12.pack_conv3x3_weights(w1)),
            "wm": (k12.pack_stem_mma_weights(w0),
                   k12.pack_conv3x3_mma_weights(w1)),
            "s0": vec(30 / std0, 60 / std0), "b0": vec(-5, 40),
            "s1": vec(30 / std1, 60 / std1), "b1": vec(-5, 5)}


def event_ms(fn, runs=10):
    import statistics

    import torch

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


def wrapper_times() -> int:
    """``--wrapper``: K10 through its public wrapper on the served call
    (512x512, batch 32, f=32; the tensor-core packs given where the
    checkout's wrapper takes them), K1's stem and blk0_conv1 through K1's
    wrapper, and the served U-Net forward (f=32, 10 classes, seeded random
    weights, z-score and graph) with the fused stem off and on at batch 32
    and 128; CUDA-event medians of 10 and device times, in the checkout
    the script runs from. Run from two checkouts in one call on the card
    (parent, this, this, parent), it compares them."""
    import inspect

    import numpy as np
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
        preprocess,
    )

    if not torch.cuda.is_available():
        print("k10_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    print(card(), flush=True)
    dev = torch.device("cuda")
    a = case(dev, np.random.default_rng(0), 32, 512, 512)
    takes_mma = "w_mma" in inspect.signature(k10.stem_conv_int8).parameters
    extra = (a["wm"],) if takes_mma else ()
    args = (a["x"], a["wk"][0], a["s0"], a["b0"], a["wk"][1], a["s1"],
            a["b1"])

    def fused():
        return k10.stem_conv_int8(*args, *extra)

    def two():
        mid = k12.conv3x3_int8((a["x"],), a["wk"][0], a["s0"], a["b0"],
                               w_mma=a["wm"][0])
        return k12.conv3x3_int8((mid,), a["wk"][1], a["s1"], a["b1"],
                                pool=True, w_mma=a["wm"][1])

    with torch.inference_mode():
        for label, fn in (("K10", fused), ("K1 + K1", two)):
            print(f"wrapper {label} (32, 512, 512) f=32: event "
                  f"{event_ms(fn):.4f} ms, device {device_ms(fn):.4f} ms",
                  flush=True)
    del a, args
    model = cli.build_model(num_classes=10, init_features=32, seed=0,
                            device=dev)
    _, calib = cli.build_psrp_forward(model, image_size=512, device=dev,
                                      seed=0)
    qp = calib["qparams"]
    for n in (32, 128):
        xb = torch.tensor(
            np.random.default_rng(n).uniform(0, 255, (n, 512, 512, 1)),
            dtype=torch.float32, device=dev)
        for fuse in (False, True, True, False):
            with torch.inference_mode():
                ms = event_ms(lambda: unet_psrp_forward(
                    qp, preprocess(xb), 10, stem_fuse=fuse))
            print(f"wrapper served forward batch {n}, fused stem "
                  f"{'on' if fuse else 'off'}: {ms:.3f} ms", flush=True)
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
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    if not torch.cuda.is_available():
        print("k10_probe: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    print(card(), flush=True)
    src = (_build.CSRC / "stem_conv_int8.cu").read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, text in builds(src).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "mma_int8.cuh").write_text(header)
            cu, so = d / "stem_conv_int8.cu", d / "k10.so"
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
                print("ptxas:\n" + "\n".join(ptxas_lines(out)), flush=True)
            lib = ctypes.CDLL(str(so))
            for fn in ("octseg_stem_conv_int8_mma", "octseg_stem_conv_int8"):
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def mma(lib, a, plan):
        """One launch of the mma.sync body at ``plan`` from ``lib``."""
        N, H, W, _ = a["x"].shape
        y = torch.empty((N, H, W, 32), dtype=torch.int8, device=dev)
        yp = torch.empty((N, H // 2, W // 2, 32), dtype=torch.int8,
                         device=dev)

        def run():
            _build.check(lib.octseg_stem_conv_int8_mma(
                a["x"].data_ptr(), a["wm"][0].data_ptr(), a["s0"].data_ptr(),
                a["b0"].data_ptr(), a["wm"][1].data_ptr(), a["s1"].data_ptr(),
                a["b1"].data_ptr(), y.data_ptr(), yp.data_ptr(), N, H, W,
                plan.band, plan.grid, plan.smem, stream), "K10 probe")
            return y, yp
        return run

    def dp4a(lib, a):
        """One launch of the dp4a body on the same call."""
        N, H, W, _ = a["x"].shape
        y = torch.empty((N, H, W, 32), dtype=torch.int8, device=dev)
        yp = torch.empty((N, H // 2, W // 2, 32), dtype=torch.int8,
                         device=dev)

        def run():
            _build.check(lib.octseg_stem_conv_int8(
                a["x"].data_ptr(), a["wk"][0].data_ptr(), a["s0"].data_ptr(),
                a["b0"].data_ptr(), a["wk"][1].data_ptr(), a["s1"].data_ptr(),
                a["b1"].data_ptr(), y.data_ptr(), yp.data_ptr(), N, H, W, 32,
                32, 32, 32, 32, stream), "K10 dp4a probe")
            return y, yp
        return run

    for n, h, w in ((2, 512, 512), (3, 14, 48)):
        a = case(dev, gen, n, h, w)
        want = k10.stem_conv_int8_reference(
            a["x"], a["wk"][0], a["s0"], a["b0"], a["wk"][1], a["s1"],
            a["b1"])
        plan = k10.stem_conv_plan(n, h, w, 32, 32, sms=sms)
        for label, fn in (("kernel", mma(libs["kernel"], a, plan)),
                          ("vmaxu4", mma(libs["vmaxu4"], a, plan)),
                          ("stem_unroll2", mma(libs["stem_unroll2"], a, plan)),
                          ("blocks1", mma(libs["blocks1"], a, plan)),
                          ("dp4a", dp4a(libs["kernel"], a))):
            got = fn()
            torch.cuda.synchronize()
            if not all(torch.equal(g, x) for g, x in zip(got, want)):
                raise RuntimeError(f"K10 {label} differs from its plain "
                                   f"version at {(n, h, w)}")
        del a
    print("bit-equal at (2, 512, 512) and (3, 14, 48), f=32: the mma.sync "
          "body (and its vmaxu4, stem_unroll2 and blocks1 builds) at the "
          "plan's launch and the dp4a body", flush=True)

    n, h = 32, 512
    a = case(dev, gen, n, h, h)
    plan = k10.stem_conv_plan(n, h, h, 32, 32, sms=sms)
    pixels = n * h * h
    nbytes = pixels * 41 + 9 * 32 * 33 + 4 * 32 * 4
    ops = 2 * pixels * 9 * (32 + 32 * 32)
    bound = max(nbytes / HBM, ops / INT8) * 1e3
    print(f"plan {plan.text()}; bound {bound:.4f} ms (bytes "
          f"{nbytes / HBM * 1e3:.4f}, operations {ops / INT8 * 1e3:.4f})",
          flush=True)
    times = {"kernel": device_ms(mma(libs["kernel"], a, plan))}
    for b in builds(src):
        if b not in ("kernel", "blocks1"):
            times[b] = device_ms(mma(libs[b], a, plan))
    for band in (16, 32, 128, 256):
        p = plan._replace(band=band, grid=min(n * -(-h // band),
                                              plan.blocks_per_sm * sms))
        times[f"band {band} (grid {p.grid})"] = device_ms(mma(libs["kernel"],
                                                              a, p))
    one = plan._replace(band=128, grid=min(n * 4, sms))
    times["one block an SM"] = device_ms(mma(libs["kernel"], a, one))
    times["blocks1, one block an SM"] = device_ms(mma(libs["blocks1"], a, one))
    times["dp4a body"] = device_ms(dp4a(libs["kernel"], a))

    def two():
        mid = k12.conv3x3_int8((a["x"],), a["wk"][0], a["s0"], a["b0"],
                               w_mma=a["wm"][0])
        return k12.conv3x3_int8((mid,), a["wk"][1], a["s1"], a["b1"],
                                pool=True, w_mma=a["wm"][1])

    times["K1 + K1"] = device_ms(two)
    y = torch.empty((n, h, h, 32), dtype=torch.int8, device=dev)
    yp = torch.empty((n, h // 2, h // 2, 32), dtype=torch.int8, device=dev)

    def zero():
        y.zero_()
        yp.zero_()

    times["zero_ (yardstick)"] = device_ms(zero)
    times["kernel again"] = device_ms(mma(libs["kernel"], a, plan))
    print(f"K10 {h}^2 x 1 -> 32 -> 32 + pool, batch {n}: " + ", ".join(
        f"{b} {t:.4f} ms ({100 * bound / t:.1f}%)" for b, t in times.items()),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(wrapper_times() if sys.argv[1:] == ["--wrapper"] else main())
