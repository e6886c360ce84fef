#!/usr/bin/env python3
"""Where K8's time goes on the card: the fused loss's statistics
(``csrc/dice_ce.cu:dice_ce_stats_kernel``, one cooperative launch) built
as it is and with parts of its work taken out, beside the two-kernel body
it replaced, timed at the packed train step's shape (8, 512, 512, 10):
bf16 logits with int64 labels and with int32 labels, fp32 logits with
int64 labels.

    python3 k8_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc with ``-Xptxas -v``, into a temporary
directory with its own copy of ``csrc/mma_int8.cuh``):
- ``kernel``: the source as it is, with the body it replaced appended
  (``OLD_BODY``: pass 1 gives each of at most 1024 blocks a contiguous
  range of pixels, a thread reading its pixel's C logits as C loads of 2
  or 4 bytes; pass 2 a second kernel of 3C + 2 blocks, a 256-thread fp64
  tree each; entry point ``octseg_dice_ce_stats_two_kernels``). The
  kernel is checked bit-equal to the package's wrapper, and both bodies
  within 1e-5 relative of the float64 plain version, at every shape;
- ``copies``: only the cp.async ring runs (each tile's copies, waits and
  barriers; no arithmetic, no partials, no grid barrier, no pass 2);
- ``pass1``: pass 1 as it is, without the grid barrier and pass 2;
- ``maxc16``: C = 10 on the 16-class instance (its class loops issue 16
  iterations, 6 of them predicated off), not on the exact one.

Prints the card's name and power limit, each build's registers and
spills (ptxas), then per shape the byte bound (logits and labels read
once) and the device time of one call of each (``torch.profiler``: each
kernel's mean recorded duration over two windows of 10 calls, summed over
the kernels of a call: the old body's two) with its share of the bound's
rate, and the plan with its blocks.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

from k3_probe import device_ms, ptxas_lines

HBM = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
SHAPES = [("bf16", "int64"), ("bf16", "int32"), ("fp32", "int64")]
N, HW, NC = 8, 512, 10
COMPUTE = "        // thread t adds pixels t, t + THREADS, ... of the tile, in order\n"
PARTIAL = "    // the block's partial: the warp trees, then the warps in order\n"
SYNC = "    cg::this_grid().sync();\n"
EXACT = "MAXC == 16 && C == STATS_EXACT_C"
# K8 as it was before its cooperative body (csrc/dice_ce.cu), appended to
# the source: it uses that file's softmax_pixel, warp_sum and
# OCTSEG_DISPATCH
OLD_BODY = r"""
namespace {

// Pass 1: block b sums pixels [b * rows, min(P, (b + 1) * rows)) and writes
// partial[b][0 .. 3C + 2).
template <int MAXC, typename T, typename L>
__global__ void __launch_bounds__(THREADS) dice_ce_stats_partial(
    const T* __restrict__ x, const L* __restrict__ lab,
    const float* __restrict__ cw, float* __restrict__ partial, long long P,
    int C, long long rows) {
    __shared__ float cws[MAX_C];
    __shared__ float sh[WARPS][3 * MAX_C + 2];
    for (int i = threadIdx.x; i < C; i += THREADS) cws[i] = cw[i];
    __syncthreads();

    float inter[MAXC], sp[MAXC], cnt[MAXC];
#pragma unroll
    for (int c = 0; c < MAXC; ++c) inter[c] = sp[c] = cnt[c] = 0.0f;
    float sll = 0.0f, sw = 0.0f;

    const long long p0 = (long long)blockIdx.x * rows;
    const long long p1 = min(P, p0 + rows);
    for (long long p = p0 + threadIdx.x; p < p1; p += THREADS) {
        const int l = static_cast<int>(lab[p]);
        float e[MAXC], m, x_l;
        const float s = softmax_pixel<MAXC>(x + p * C, C, l, e, m, x_l);
        const float inv = 1.0f / s;
        const float logs = logf(s);
        float w = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            if (c < C) {
                const float pc = e[c] * inv;
                sp[c] += pc;
                if (c == l) {
                    inter[c] += pc;
                    cnt[c] += 1.0f;
                    w = cws[c];
                }
            }
        }
        sll += (x_l - m - logs) * w;
        sw += w;
    }

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
        if (c < C) {
            const float a = warp_sum(inter[c]);
            const float b = warp_sum(sp[c]);
            const float d = warp_sum(cnt[c]);
            if (lane == 0) {
                sh[warp][c] = a;
                sh[warp][C + c] = b;
                sh[warp][2 * C + c] = d;
            }
        }
    }
    const float a = warp_sum(sll), b = warp_sum(sw);
    if (lane == 0) {
        sh[warp][3 * C] = a;
        sh[warp][3 * C + 1] = b;
    }
    __syncthreads();
    const int K = 3 * C + 2;
    for (int k = threadIdx.x; k < K; k += THREADS) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < WARPS; ++j) v += sh[j][k];
        partial[(size_t)blockIdx.x * K + k] = v;
    }
}

// Pass 2: block k writes out[k] = sum over g of partial[g][k]: each thread
// sums a fixed strided subset in fp64, then a fixed tree over the threads.
__global__ void __launch_bounds__(THREADS) dice_ce_stats_final(
    const float* __restrict__ partial, float* __restrict__ out, int G,
    int K) {
    __shared__ double sh[THREADS];
    const int k = blockIdx.x;
    double v = 0.0;
    for (int g = threadIdx.x; g < G; g += THREADS)
        v += (double)partial[(size_t)g * K + k];
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int w = THREADS / 2; w > 0; w >>= 1) {
        if (threadIdx.x < w) sh[threadIdx.x] += sh[threadIdx.x + w];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[k] = (float)sh[0];
}

template <int MAXC, typename T, typename L>
int stats_two_kernels(const void* x, const void* lab, const void* cw,
                      void* partial, void* out, long long P, int C, int G,
                      long long rows, cudaStream_t s) {
    dice_ce_stats_partial<MAXC, T, L><<<G, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const L*>(lab),
        static_cast<const float*>(cw), static_cast<float*>(partial), P, C,
        rows);
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    dice_ce_stats_final<<<3 * C + 2, THREADS, 0, s>>>(
        static_cast<const float*>(partial), static_cast<float*>(out), G,
        3 * C + 2);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int octseg_dice_ce_stats_two_kernels(
    const void* x, const void* lab, const void* cw, void* partial, void* out,
    long long P, int C, int G, long long rows, int bf16, int lab64,
    void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    OCTSEG_DISPATCH(stats_two_kernels, x, lab, cw, partial, out, P, C, G,
                    rows, s);
}
"""


def old_groups(P: int) -> tuple[int, int]:
    """The old body's (G, pixels a block): at most 1024 blocks of at least
    1024 pixels."""
    G = max(1, min(-(-P // 1024), 1024))
    rows = -(-P // G)
    return -(-P // rows), rows


def stats_lines(lines: list[str]) -> list[str]:
    """ptxas's lines for K8's kernels, old and new (K9's left out)."""
    keep, on = [], False
    for line in lines:
        if "Compiling entry function" in line:
            on = "stats" in line
        if on:
            keep.append(line)
    return keep


def builds(src: str) -> dict[str, str]:
    """name -> source (the old body appended to each)."""
    for line in (COMPUTE, PARTIAL, SYNC, EXACT):
        if src.count(line) != 1:
            raise RuntimeError("k8_probe: the K8 source no longer has the "
                               f"line this probe edits: {line!r}")
    # run-time conditions that always / never hold: the code stays compiled
    skip = ("        if (C > 0) {\n"
            "            slot = slot == STATS_STAGES - 1 ? 0 : slot + 1;\n"
            "            continue;\n        }\n")
    copies = src.replace(COMPUTE, skip + COMPUTE).replace(
        PARTIAL, "    if (C > 0) return;\n" + PARTIAL)
    return {name: text + OLD_BODY for name, text in (
        ("kernel", src), ("copies", copies),
        ("pass1", src.replace(SYNC, "    if (C > 0) return;\n" + SYNC)),
        ("maxc16", src.replace(EXACT, "MAXC == 16 && C == -STATS_EXACT_C")))}


def main() -> int:
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        dice_ce as k89,
    )

    if not torch.cuda.is_available():
        print("k8_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "dice_ce.cu").read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    sig = _build.SIGNATURES["octseg_dice_ce_stats"]
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, text in builds(src).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "mma_int8.cuh").write_text(header)
            cu, so = d / "dice_ce.cu", d / "k8.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            print(f"{name}: ptxas (K8's instances)", flush=True)
            print("\n".join(stats_lines(ptxas_lines(out))), flush=True)
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in (
                    ("octseg_dice_ce_stats", sig),
                    ("octseg_dice_ce_stats_resident",
                     _build.SIGNATURES["octseg_dice_ce_stats_resident"]),
                    ("octseg_dice_ce_stats_two_kernels",
                     [P_] * 5 + [L_, I_, I_, L_, I_, I_, P_])):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32,
              "int64": torch.int64, "int32": torch.int32}

    def plan_of(lib, x, lab):
        C = x.shape[-1]
        n = ctypes.c_int(0)
        _build.check(lib.octseg_dice_ce_stats_resident(
            C, int(x.dtype == torch.bfloat16), int(lab.dtype == torch.int64),
            ctypes.addressof(n)), "K8 probe occupancy")
        return k89.stats_plan(x.numel() // C, C, x.element_size(),
                              lab.element_size(), co_resident=n.value)

    def runner(name, x, lab, cw, old=False):
        lib = libs[name]
        C = x.shape[-1]
        P = x.numel() // C
        out = torch.empty(3 * C + 2, dtype=torch.float32, device=dev)
        flags = (int(x.dtype == torch.bfloat16), int(lab.dtype == torch.int64))
        if old:
            G, rows = old_groups(P)
            partial = torch.empty((G, 3 * C + 2), dtype=torch.float32,
                                  device=dev)
            fn, tail = lib.octseg_dice_ce_stats_two_kernels, (G, rows, *flags)
        else:
            grid = plan_of(lib, x, lab).grid
            partial = torch.empty((grid, 3 * C + 2), dtype=torch.float32,
                                  device=dev)
            fn, tail = lib.octseg_dice_ce_stats, (*flags, grid)

        def run():
            _build.check(fn(x.data_ptr(), lab.data_ptr(), cw.data_ptr(),
                            partial.data_ptr(), out.data_ptr(), P, C, *tail,
                            stream), f"K8 probe {name}")
            return out
        return run

    for xd, ld in SHAPES:
        x = (torch.randn((N, HW, HW, NC), generator=g, device=dev)
             * 3).to(dtypes[xd])
        lab = torch.randint(0, NC, (N, HW, HW), generator=g,
                            device=dev).to(dtypes[ld])
        lab.view(-1)[::97] = NC  # outside the classes
        cw = torch.linspace(0.5, 2.0, NC, device=dev)
        P = N * HW * HW
        got = runner("kernel", x, lab, cw)().clone()
        old = runner("kernel", x, lab, cw, old=True)().clone()
        maxc16 = runner("maxc16", x, lab, cw)().clone()
        pkg = k89.dice_ce_stats(x, lab, cw)
        exact = k89.dice_ce_stats_reference(x.double(), lab, cw).double()
        torch.cuda.synchronize()
        rel = [float(((t.double() - exact).abs()
                      / exact.abs().clamp_min(1e-30)).max())
               for t in (got, old, maxc16)]
        same = torch.equal(got, pkg)
        print(f"{xd} logits, {ld} labels: kernel bit-equal to the package's "
              f"wrapper {same}; largest relative error vs float64: kernel "
              f"{rel[0]:.3e}, the body it replaced {rel[1]:.3e}, maxc16 "
              f"{rel[2]:.3e} (limit 1e-5)", flush=True)
        if not same or max(rel) > 1e-5:
            raise RuntimeError("K8 probe: the builds disagree")
        nbytes = x.numel() * x.element_size() + P * lab.element_size() \
            + 4 * NC + 4 * (3 * NC + 2)
        bound = nbytes / HBM * 1e3
        print(f"  bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB); plan "
              f"{plan_of(libs['kernel'], x, lab).text()}; the old body "
              f"{old_groups(P)[0]} + {3 * NC + 2} blocks", flush=True)
        for name, o in (("kernel", False), ("two_kernels", True),
                        ("copies", False), ("pass1", False),
                        ("maxc16", False)):
            ms = device_ms(runner("kernel" if o else name, x, lab, cw, o))
            print(f"  {name:12s} device {ms:.4f} ms ({nbytes / ms / 1e6:.0f} "
                  f"GB/s, {100 * bound / ms:.1f}% of the bound's rate)",
                  flush=True)
        del x, lab, got, old, pkg
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
