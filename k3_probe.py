#!/usr/bin/env python3
"""Where K3's time goes on the card: the served head + argmax
(``csrc/head_argmax.cu:head_argmax_mma``) built as it is and with parts of
its work taken out, beside the body it replaced and the alternative
design, timed at the U-Net's head (batch 32, 512x512, 32 channels -> 10
classes) and ReLayNet's (64 channels -> 10).

    python3 k3_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc with ``-Xptxas -v``, into a temporary
directory with its own copy of ``csrc/mma_int8.cuh``):
- ``kernel``: the source as it is (checked bit-equal to the plain version,
  batch 2, before anything is timed);
- ``copies``: only the cp.async ring runs (each tile's copies, waits and
  barriers; no ldmatrix, products, epilogue or stores);
- ``no_stores``: the labels are computed and staged, not stored;
- ``one_thread_a_pixel``: the body K3 had before (``OLD_SOURCE``: a
  thread owns a pixel, cin/4 word loads, nc*cin/4 dp4a with the weights
  read from shared memory), for time only;
- ``dp4a16``: the alternative design (``DP4A_SOURCE``): a thread owns a
  pixel, reads it in 16-byte loads and keeps every weight word in
  registers (a template instance a (cin, nc));
- ``blocks4``, ``blocks5``: registers held to four or five blocks an SM
  (``__launch_bounds__``; the source leaves them to the compiler).

Prints the card's name and power limit, each build's registers and
spills (ptxas), then per head the byte bound (the input read once, the
labels written once) and each build's device time of one call
(``torch.profiler``: each kernel's mean recorded duration over two
windows of 10 calls) with its share of the bound's rate.
"""

from __future__ import annotations

import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

HBM = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
HEADS = [("U-Net head", 32, 512, 32, 10), ("ReLayNet head", 32, 512, 64, 10)]
COMPUTE = "        const uint32_t base = ring + slot * SLOT + a_off;\n"
STORES = "        if (lane < 2) {\n"
BOUNDS = "__launch_bounds__(THREADS) head_argmax_mma("
# K3 as it was before its tensor-core body (csrc/head_argmax.cu)
OLD_SOURCE = r"""// K3: 1x1 int8 classifier head fused with the per-pixel argmax, NHWC int8
// in, int8 labels out.
//
// Replaces ops/pallas_conv_psrp.py:head_argmax_psrp.
//
// Function, per pixel p: acc[k] = sum_c x[p,c] * w[k,c] in int32, logit
// z[k] = fmaf(float(acc[k]), scale[k], bias[k]) (no round, no clip), label =
// argmax_k z[k] with ties to the lowest class (a strict '>' scan from
// class 0). The logits never leave registers.
//
// Bound on the card: reading the input (cin bytes per pixel) from device
// memory; the nc*cin/4 dp4a per pixel are few. One thread per pixel keeps
// its cin/4 input words in registers and reads the weights, scales and
// biases from shared memory (uniform across the warp: broadcast).
//
// Weights are pre-arranged (ops/head_argmax.py:pack_head_weights) as int32
// words (nc, cin/4): word [k, j] holds w[k, 4j..4j+3].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CW = 16;   // cin <= 64
constexpr int MAX_NC = 32;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) head_argmax_kernel(
    const int8_t* __restrict__ x, const int32_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int8_t* __restrict__ y, long long P, int cw, int nc) {
    __shared__ int32_t ws[MAX_NC * MAX_CW];
    __shared__ float ss[MAX_NC], bs[MAX_NC];
    for (int i = threadIdx.x; i < nc * cw; i += THREADS) ws[i] = w[i];
    for (int i = threadIdx.x; i < nc; i += THREADS) {
        ss[i] = scale[i];
        bs[i] = bias[i];
    }
    __syncthreads();

    const long long stride = (long long)gridDim.x * THREADS;
    for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < P;
         p += stride) {
        const int32_t* xp = reinterpret_cast<const int32_t*>(x + p * cw * 4);
        int32_t xv[MAX_CW];
#pragma unroll
        for (int j = 0; j < MAX_CW; ++j) xv[j] = j < cw ? xp[j] : 0;
        float best = 0.0f;
        int arg = 0;
        for (int k = 0; k < nc; ++k) {
            int acc = 0;
#pragma unroll
            for (int j = 0; j < MAX_CW; ++j)
                if (j < cw) acc = __dp4a(xv[j], ws[k * cw + j], acc);
            const float z = __fmaf_rn(__int2float_rn(acc), ss[k], bs[k]);
            if (k == 0 || z > best) {
                best = z;
                arg = k;
            }
        }
        y[p] = static_cast<int8_t>(arg);
    }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). cin = 4*cw
// with cw <= 16; nc <= 32.
extern "C" int octseg_head_argmax(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* y, long long P, int cw, int nc,
                                  void* stream) {
    long long blocks = (P + THREADS - 1) / THREADS;
    if (blocks > 65535LL * 16) blocks = 65535LL * 16;
    if (blocks < 1) blocks = 1;
    head_argmax_kernel<<<(unsigned)blocks, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(x), static_cast<const int32_t*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<int8_t*>(y), P, cw, nc);
    return static_cast<int>(cudaGetLastError());
}
"""
# the alternative design
DP4A_SOURCE = r"""// A thread owns a pixel: cin/16 16-byte loads, every weight word in
// registers (W[k][j] = w[k, 4j..4j+3]), nc*cin/4 dp4a, a strict '>'
// scan from class 0, one byte stored.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int CW, int NC>
__global__ void __launch_bounds__(256) head_dp4a16(
    const int8_t* __restrict__ x, const int32_t* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ bias,
    int8_t* __restrict__ y, long long P) {
    int W[NC][CW];
    float S[NC], B[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
#pragma unroll
        for (int j = 0; j < CW; ++j) W[k][j] = __ldg(w + k * CW + j);
        S[k] = __ldg(scale + k);
        B[k] = __ldg(bias + k);
    }
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x; p < P;
         p += stride) {
        int xv[CW];
        const int4* xp = reinterpret_cast<const int4*>(x + p * CW * 4);
#pragma unroll
        for (int i = 0; i < CW / 4; ++i) {
            const int4 v = __ldg(xp + i);
            xv[4 * i] = v.x;
            xv[4 * i + 1] = v.y;
            xv[4 * i + 2] = v.z;
            xv[4 * i + 3] = v.w;
        }
        float best = 0.0f;
        int arg = 0;
#pragma unroll
        for (int k = 0; k < NC; ++k) {
            int acc = 0;
#pragma unroll
            for (int j = 0; j < CW; ++j) acc = __dp4a(xv[j], W[k][j], acc);
            const float z = __fmaf_rn(__int2float_rn(acc), S[k], B[k]);
            if (k == 0 || z > best) {
                best = z;
                arg = k;
            }
        }
        y[p] = static_cast<int8_t>(arg);
    }
}

}  // namespace

// cin 32 or 64, nc 10; grid blocks of 256 threads.
extern "C" int octseg_head_dp4a16(const void* x, const void* w,
                                  const void* scale, const void* bias,
                                  void* y, long long P, int cin, int nc,
                                  int grid, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    auto xs = static_cast<const int8_t*>(x);
    auto ws = static_cast<const int32_t*>(w);
    auto ss = static_cast<const float*>(scale);
    auto bs = static_cast<const float*>(bias);
    auto ys = static_cast<int8_t*>(y);
    if (nc != 10 || (cin != 32 && cin != 64))
        return static_cast<int>(cudaErrorInvalidValue);
    if (cin == 32)
        head_dp4a16<8, 10><<<grid, 256, 0, s>>>(xs, ws, ss, bs, ys, P);
    else
        head_dp4a16<16, 10><<<grid, 256, 0, s>>>(xs, ws, ss, bs, ys, P);
    return static_cast<int>(cudaGetLastError());
}
"""


def builds(src: str) -> dict[str, str]:
    """name -> source (each includes mma_int8.cuh or nothing)."""
    for line in (COMPUTE, STORES, BOUNDS):
        if src.count(line) != 1:
            raise RuntimeError("k3_probe: the K3 source no longer has the "
                               f"line this probe edits: {line!r}")
    # run-time conditions that always / never hold: the code stays compiled
    skip = ("        if (cin > 0) {\n"
            "            slot = slot == STAGES - 1 ? 0 : slot + 1;\n"
            "            continue;\n"
            "        }\n")
    return {"kernel": src,
            "copies": src.replace(COMPUTE, skip + COMPUTE),
            "no_stores": src.replace(STORES, STORES.replace(
                "lane < 2", "lane < 2 && cin < 0")),
            "one_thread_a_pixel": OLD_SOURCE, "dp4a16": DP4A_SOURCE,
            **{f"blocks{n}": src.replace(BOUNDS, BOUNDS.replace(
                "(THREADS)", f"(THREADS, {n})")) for n in (4, 5)}}


def ptxas_lines(out: str) -> list[str]:
    """ptxas's register, shared memory and spill lines, with the entry
    function each belongs to."""
    keep = []
    for line in out.splitlines():
        if ("Compiling entry function" in line or "Used" in line
                or "spill" in line):
            keep.append("  " + line.strip())
    return keep


def device_ms(fn, runs=10, windows=2):
    """Device time of one call of ``fn``: each kernel's mean recorded
    duration over ``windows`` windows of ``runs`` calls, times its
    launches a call (the profiler may drop events; those it keeps carry
    their full durations)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kernels = {}  # name -> [recorded us, recorded events, most in a window]
    for _window in range(windows):
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


def main() -> int:
    import numpy as np
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        head_argmax as k3,
    )

    if not torch.cuda.is_available():
        print("k3_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "head_argmax.cu").read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    new_sig = _build.SIGNATURES["octseg_head_argmax"]
    entry = {"one_thread_a_pixel": ("octseg_head_argmax",
                                    new_sig[:8] + new_sig[9:]),
             "dp4a16": ("octseg_head_dp4a16", new_sig)}
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, text in builds(src).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "mma_int8.cuh").write_text(header)
            cu, so = d / "head_argmax.cu", d / "k3.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            print(f"{name}: ptxas", flush=True)
            print("\n".join(ptxas_lines(out)), flush=True)
            lib = ctypes.CDLL(str(so))
            fn, argtypes = entry.get(name, ("octseg_head_argmax", new_sig))
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
            if fn == "octseg_head_argmax" and name != "one_thread_a_pixel":
                lib.octseg_head_argmax_resident.argtypes = \
                    _build.SIGNATURES["octseg_head_argmax_resident"]
                lib.octseg_head_argmax_resident.restype = ctypes.c_int
            libs[name] = (lib, fn)

    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def args(n, h, cin, nc):
        x = torch.tensor(gen.integers(-127, 128, (n, h, h, cin)),
                         dtype=torch.int8, device=dev)
        w = torch.tensor(gen.integers(-40, 41, (nc, cin)), dtype=torch.int8,
                         device=dev)
        scale = torch.tensor(gen.uniform(30, 60, nc) / cin ** 0.5 / 73 / 40,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, nc), dtype=torch.float32,
                            device=dev)
        return x, w, scale, bias

    def runner(name, x, w, scale, bias):
        """One launch of build ``name``."""
        lib, fn = libs[name]
        cin, nc = x.shape[-1], scale.shape[0]
        P = x.numel() // cin
        y = torch.empty(x.shape[:3], dtype=torch.int8, device=dev)
        if name not in ("one_thread_a_pixel", "dp4a16"):
            n = ctypes.c_int(0)
            _build.check(lib.octseg_head_argmax_resident(
                cin, nc, ctypes.addressof(n)), "K3 probe occupancy")
            extra = (k3.head_plan(P, cin, nc, co_resident=n.value).grid,)
        elif name == "dp4a16":
            extra = (min(-(-P // 256), 16 * sms),)
        else:
            extra = ()
        cw = (cin if name != "one_thread_a_pixel" else cin // 4,)

        def run():
            _build.check(getattr(lib, fn)(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                y.data_ptr(), P, *cw, nc, *extra, stream), f"K3 probe {name}")
            return y
        return run

    for label, _, h, cin, nc in HEADS:
        a = args(2, h, cin, nc)
        want = k3.head_argmax_reference(*a)
        for name in ("kernel", "one_thread_a_pixel", "dp4a16", "blocks4",
                     "blocks5"):
            got = runner(name, *a)()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise RuntimeError(f"K3 probe: {name} differs from the plain "
                                   f"version at the {label}")
        if not torch.equal(k3.head_argmax(*a), want):
            raise RuntimeError(f"K3's wrapper differs at the {label}")
        del a
    print("bit-equal to the plain version at batch 2: kernel, "
          "one_thread_a_pixel, dp4a16, blocks4, blocks5", flush=True)

    for label, n, h, cin, nc in HEADS:
        a = args(n, h, cin, nc)
        P = n * h * h
        nbytes = P * cin + P + nc * cin + 8 * nc
        bound = nbytes / HBM * 1e3
        lib, _ = libs["kernel"]
        res = ctypes.c_int(0)
        _build.check(lib.octseg_head_argmax_resident(
            cin, nc, ctypes.addressof(res)), "K3 probe occupancy")
        plan = k3.head_plan(P, cin, nc, co_resident=res.value)
        print(f"{label} ({n}, {h}, {h}, {cin}) -> {nc} classes: bound "
              f"{bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB); plan "
              f"{plan.text()}, {res.value // sms} blocks an SM", flush=True)
        for name in libs:
            ms = device_ms(runner(name, *a))
            print(f"  {name:18s} device {ms:.4f} ms ({nbytes / ms / 1e6:.0f} "
                  f"GB/s, {100 * bound / ms:.1f}% of the bound's rate)",
                  flush=True)
        del a
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
