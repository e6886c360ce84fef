#!/usr/bin/env python3
"""Where K6's time goes on the card: the training BatchNorm's pair sums
(``csrc/bn_pair_sums.cu``) built as they are and with parts of the work
taken out, timed at the U-Net train step's 512²x32, 128²x128 and 32²x512
BatchNorm shapes (batch 8, bf16) and SDNet's 512²x32 and 512²x1 (batch 4,
float32), in both modes.

    python3 k6_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc, into a temporary directory):
- ``kernel``: the source as it is (checked bit-equal to the package's
  build);
- ``no_pass2``: each block returns after writing its partial (no grid
  barrier, no cross-block tree; the output is not written);
- ``no_kahan``: plain fp32 adds in the lanes (timing only);
- ``no_tree``: the block's tree over its lanes skipped (lane row 0's pairs
  are the partial; timing only);
- ``unroll_half``: half the rows in flight a lane (2 or 4, not 4 or 8);
- ``3_per_sm``: registers held to three blocks an SM (two in the source).

and runs the kernel also on other plans: ``width1``, the width-1 layout
(``pair_sums_plan`` with ``aligned=False``: a lane owns one channel, 2- or
4-byte loads), and ``steps/4``, ``steps*4``, blocks of a quarter or four
times ``MIN_STEPS`` block steps at least (so more or fewer blocks where
the grid is not already at the co-resident bound).

Prints the card's name and power limit, each build's registers (ptxas),
then per shape, mode and build the device time of one call
(``torch.profiler``, mean of 20), its plan, and beside them the library's
call (``torch.var_mean`` / ``torch.linalg.vecdot``) and the byte bound.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

HBM = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
SHAPES = [  # (N, H, W, C, dtype name)
    (8, 512, 512, 32, "bf16"), (8, 128, 128, 128, "bf16"),
    (8, 32, 32, 512, "bf16"), (4, 512, 512, 32, "fp32"),
    (4, 512, 512, 1, "fp32"),
]
EDITS = {
    "no_pass2": ("    cg::this_grid().sync();\n", "    return;\n"),
    "no_kahan": ("    e = y - (t - s);\n", "    e = 0.0f;\n"),
    "no_tree": ("for (int n = rows_step; n > 1;) {",
                "for (int n = 1; n > 1;) {"),
    "unroll_half": ("? 4 : 8;", "? 2 : 4;"),
    "3_per_sm": ("__launch_bounds__(THREADS, 2)",
                 "__launch_bounds__(THREADS, 3)"),
}
# (label, build, plan: aligned, MIN_STEPS factor)
RUNS = [("kernel", "kernel", True, 1), ("no_pass2", "no_pass2", True, 1),
        ("no_kahan", "no_kahan", True, 1), ("no_tree", "no_tree", True, 1),
        ("unroll_half", "unroll_half", True, 1),
        ("3_per_sm", "3_per_sm", True, 1), ("width1", "kernel", False, 1),
        ("steps/4", "kernel", True, 0.25), ("steps*4", "kernel", True, 4)]


def builds(src: str) -> dict[str, str]:
    out = {"kernel": src}
    for name, (old, new) in EDITS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"k6_probe: the K6 source no longer has the "
                               f"line {name} edits: {old!r}")
        out[name] = src.replace(old, new)
    return out


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )

    if not torch.cuda.is_available():
        print("k6_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "bn_pair_sums.cu").read_text()
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, text in builds(src).items():
            cu, so = Path(tmp) / f"{name}.cu", Path(tmp) / f"{name}.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-I", str(_build.CSRC), "-shared", "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            regs = [line.split("Used ")[1].split(",")[0]
                    for line in out.splitlines() if "registers" in line]
            print(f"{name}: ptxas {regs} (instances <float, false|true, 1>, "
                  f"<float, ., 8>, <bf16, ., 1>, <bf16, ., 8>)")
            lib = ctypes.CDLL(str(so))
            for fn in ("octseg_bn_pair_sums", "octseg_bn_pair_sums_resident"):
                getattr(lib, fn).argtypes = _build.SIGNATURES[fn]
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    min_steps = k6.MIN_STEPS

    def plan_of(lib, a, b, aligned=True, factor=1):
        C = a.shape[-1]
        n = ctypes.c_int(0)
        vec = 8 if C % 8 == 0 and aligned else 1
        _build.check(lib.octseg_bn_pair_sums_resident(
            int(a.dtype == torch.bfloat16), int(b is not None), vec,
            ctypes.addressof(n)), "K6 probe occupancy")
        k6.MIN_STEPS = int(min_steps * factor)
        try:  # past the plan's cache, which does not see MIN_STEPS
            return k6.pair_sums_plan.__wrapped__(
                a.numel() // C, C, a.dtype, aligned=aligned,
                co_resident=n.value)
        finally:
            k6.MIN_STEPS = min_steps

    def call(lib, a, b, plan):
        C = a.shape[-1]
        part = torch.empty((2, 2 * C, plan.grid), device=dev)
        out = torch.empty((2, C), device=dev)
        _build.check(lib.octseg_bn_pair_sums(
            a.data_ptr(), None if b is None else b.data_ptr(),
            part.data_ptr(), out.data_ptr(), plan.M, C, plan.vec, plan.lanes,
            plan.rows_step, plan.grid, plan.rows_block,
            int(a.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream), "K6 probe")
        return out

    def device_ms(run, runs=10):
        """Device time of one call: each kernel's mean recorded duration
        over three windows of ``runs`` calls (the profiler may drop
        events), summed over the kernels a call launches."""
        run()
        torch.cuda.synchronize()
        kernels = {}  # name -> [recorded us, recorded events, most a window]
        for _window in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    run()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA and e.count:
                    k = kernels.setdefault(e.key, [0.0, 0, 0])
                    k[0] += e.self_device_time_total
                    k[1] += e.count
                    k[2] = max(k[2], e.count)
        if not kernels:
            return float("nan")
        return sum(us / n * -(-most // runs)
                   for us, n, most in kernels.values()) / 1e3

    for n, h, w, c, dname in SHAPES:
        dtype = torch.bfloat16 if dname == "bf16" else torch.float32
        a = (torch.randn((n, h, w, c), generator=g, device=dev) + 1).to(dtype)
        x = (torch.randn((n, h, w, c), generator=g, device=dev) + 1).to(dtype)
        m = n * h * w
        for mode, b in (("fwd", None), ("bwd", x)):
            want = k6.pair_sums(a, b)
            got = call(libs["kernel"], a, b, plan_of(libs["kernel"], a, b))
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K6 probe build differs from the package's "
                                   f"at {(n, h, w, c)} {mode}")
            nbytes = (1 if b is None else 2) * m * c * a.element_size() + 8 * c
            if b is None:
                lib_ms = device_ms(lambda: torch.var_mean(
                    a, dim=(0, 1, 2), correction=0))
            else:
                a2, b2 = a.reshape(m, c), b.reshape(m, c)
                lib_ms = device_ms(lambda: torch.linalg.vecdot(a2, b2, dim=0))
            print(f"{n}x{h}x{w}x{c} {dname} {mode}: bound {nbytes / HBM * 1e3:.4f}"
                  f" ms (bytes, {nbytes / 1e6:.1f} MB), library device "
                  f"{lib_ms:.4f} ms", flush=True)
            for name, build, aligned, factor in RUNS:
                lib = libs[build]
                plan = plan_of(lib, a, b, aligned, factor)
                ms = device_ms(lambda: call(lib, a, b, plan))
                print(f"  {name:9s} device {ms:.4f} ms "
                      f"({nbytes / ms / 1e6:.0f} GB/s, "
                      f"{100 * nbytes / HBM * 1e3 / ms:.1f}% of the bound's "
                      f"rate) plan {plan.text()}", flush=True)
        del a, x
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
