#!/usr/bin/env python3
"""Where K9's time goes on the card: the fused loss's dlogits
(``csrc/dice_ce.cu:dice_ce_bwd_kernel``) built as it is and with parts of
its work taken out, beside the body it replaced, timed at the packed train
step's shape (8, 512, 512, 10): bf16 logits with int64 labels and with
int32 labels, fp32 logits with int64 labels.

    python3 k9_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc with ``-Xptxas -v``, into a temporary
directory with its own copy of ``csrc/mma_int8.cuh``):
- ``kernel``: the source as it is, with the body it replaced appended
  (``OLD_BODY``: a thread owns a pixel and reads its C logits and writes
  its C dlogits with 2- or 4-byte accesses from and to device memory;
  entry point ``octseg_dice_ce_bwd_one_thread``). Both are checked
  bit-equal to each other and to the package's wrapper at every shape;
- ``copies``: only the cp.async ring runs (each tile's copies, waits and
  barriers; no arithmetic, no output tile, no stores);
- ``no_stores``: the dlogits are computed into the shared output tile and
  not stored;
- ``maxc16``: C = 10 on the 16-class instance (its class loops issue 16
  iterations, 6 of them predicated off), not on the exact one;
- ``stages3``: a ring of three slots (two tiles in flight), not two;
- ``blocks6``: registers held to six blocks an SM (``__launch_bounds__``).

Prints the card's name and power limit, each build's registers and
spills (ptxas), then per shape the byte bound (logits and labels read
once, dlogits written once) and the device time of one call of each
(``torch.profiler``: each kernel's mean recorded duration over two
windows of 10 calls) with its share of the bound's rate, and the plan.
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
COMPUTE = "        const long long p0 = tile * BWD_TP;\n        const int np"
EXACT = "MAXC == 16 && C == BWD_EXACT_C"
STAGES = "constexpr int BWD_STAGES = 2;"
BOUNDS = "__launch_bounds__(THREADS) dice_ce_bwd_kernel("
STORES = ["        for (long long u = threadIdx.x; u < units; u += THREADS)\n",
          "             v < n; v += THREADS)\n"]
# K9 as it was before its tiled body (csrc/dice_ce.cu), appended to the
# source: it uses that file's softmax_pixel, store and OCTSEG_DISPATCH
OLD_BODY = r"""
namespace {

template <int MAXC, typename T, typename L>
__global__ void __launch_bounds__(THREADS) dice_ce_bwd_one_thread(
    const T* __restrict__ x, const L* __restrict__ lab,
    const float* __restrict__ coef, T* __restrict__ dx, long long P, int C) {
    __shared__ float cs[3 * MAX_C];
    for (int i = threadIdx.x; i < 3 * C; i += THREADS) cs[i] = coef[i];
    __syncthreads();

    const long long stride = (long long)gridDim.x * THREADS;
    for (long long p = (long long)blockIdx.x * THREADS + threadIdx.x; p < P;
         p += stride) {
        const int l = static_cast<int>(lab[p]);
        float e[MAXC], m, x_l;
        const float s = softmax_pixel<MAXC>(x + p * C, C, l, e, m, x_l);
        const float inv = 1.0f / s;
        float qA = 0.0f, qB = 0.0f, wce = 0.0f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            if (c < C) {
                const float pc = e[c] * inv;
                const float t = c == l ? 1.0f : 0.0f;
                qA += cs[c] * t * pc;
                qB += cs[C + c] * pc;
                wce += cs[2 * C + c] * t;
            }
        }
        T* out = dx + p * C;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
            if (c < C) {
                const float pc = e[c] * inv;
                const float t = c == l ? 1.0f : 0.0f;
                const float d = wce * (pc - t) + cs[c] * t * pc
                                + cs[C + c] * pc - pc * (qA + qB);
                store(out + c, d);
            }
        }
    }
}

int blocks_for(long long P) {
    long long blocks = (P + THREADS - 1) / THREADS;
    if (blocks > 132LL * 16) blocks = 132LL * 16;
    return blocks < 1 ? 1 : static_cast<int>(blocks);
}

template <int MAXC, typename T, typename L>
int bwd_one_thread(const void* x, const void* lab, const void* coef, void* dx,
        long long P, int C, cudaStream_t s) {
    dice_ce_bwd_one_thread<MAXC, T, L><<<blocks_for(P), THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const L*>(lab),
        static_cast<const float*>(coef), static_cast<T*>(dx), P, C);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int octseg_dice_ce_bwd_one_thread(const void* x, const void* lab,
                                             const void* coef, void* dx,
                                             long long P, int C, int bf16,
                                             int lab64, void* stream) {
    auto s = static_cast<cudaStream_t>(stream);
    OCTSEG_DISPATCH(bwd_one_thread, x, lab, coef, dx, P, C, s);
}
"""


def builds(src: str) -> dict[str, str]:
    """name -> source (the old body appended to each)."""
    if src.count(EXACT) != 1:
        raise RuntimeError(f"k9_probe: the K9 source no longer has {EXACT!r}")
    for line in (COMPUTE, *STORES, STAGES, BOUNDS):
        if src.count(line) != 1:
            raise RuntimeError("k9_probe: the K9 source no longer has the "
                               f"line this probe edits: {line!r}")
    # run-time conditions that always / never hold: the code stays compiled
    skip = ("        if (C > 0) {\n"
            "            slot = slot == BWD_STAGES - 1 ? 0 : slot + 1;\n"
            "            continue;\n        }\n")
    no_stores = src
    for line in STORES:
        no_stores = no_stores.replace(line, line.replace(
            "u < units", "C < 0 && u < units").replace(
            "v < n;", "C < 0 && v < n;"))
    return {name: text + OLD_BODY for name, text in (
        ("kernel", src), ("copies", src.replace(COMPUTE, skip + COMPUTE)),
        ("no_stores", no_stores),
        ("maxc16", src.replace(EXACT, "MAXC == 16 && C == -BWD_EXACT_C")),
        ("stages3", src.replace(STAGES, STAGES.replace("2", "3"))),
        ("blocks6", src.replace(BOUNDS, BOUNDS.replace(
            "(THREADS)", "(THREADS, 6)"))))}


def main() -> int:
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        dice_ce as k89,
    )

    if not torch.cuda.is_available():
        print("k9_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "dice_ce.cu").read_text()
    header = (_build.CSRC / "mma_int8.cuh").read_text()
    sig = _build.SIGNATURES["octseg_dice_ce_bwd"]
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, text in builds(src).items():
            d = Path(tmp) / name
            d.mkdir()
            (d / "mma_int8.cuh").write_text(header)
            cu, so = d / "dice_ce.cu", d / "k9.so"
            cu.write_text(text)
            jobs[name] = (so, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v",
                 "-shared", "-o", str(so), str(cu)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        for name, (so, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
            print(f"{name}: ptxas (bwd instances)", flush=True)
            print("\n".join(line for line in ptxas_lines(out)
                            if "stats" not in line), flush=True)
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in (
                    ("octseg_dice_ce_bwd", sig),
                    ("octseg_dice_ce_bwd_resident",
                     _build.SIGNATURES["octseg_dice_ce_bwd_resident"]),
                    ("octseg_dice_ce_bwd_one_thread", sig[:8] + sig[9:])):
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
        _build.check(lib.octseg_dice_ce_bwd_resident(
            C, int(x.dtype == torch.bfloat16), int(lab.dtype == torch.int64),
            ctypes.addressof(n)), "K9 probe occupancy")
        return k89.bwd_plan(x.numel() // C, C, x.element_size(),
                            lab.element_size(), co_resident=n.value)

    def runner(name, x, lab, coef, old=False):
        lib = libs[name]
        C = x.shape[-1]
        dx = torch.empty_like(x)
        flags = (int(x.dtype == torch.bfloat16), int(lab.dtype == torch.int64))
        grid = () if old else (plan_of(lib, x, lab).grid,)
        fn = lib.octseg_dice_ce_bwd_one_thread if old \
            else lib.octseg_dice_ce_bwd

        def run():
            _build.check(fn(x.data_ptr(), lab.data_ptr(), coef.data_ptr(),
                            dx.data_ptr(), x.numel() // C, C, *flags, *grid,
                            stream), f"K9 probe {name}")
            return dx
        return run

    for xd, ld in SHAPES:
        x = (torch.randn((N, HW, HW, NC), generator=g, device=dev)
             * 3).to(dtypes[xd])
        lab = torch.randint(0, NC, (N, HW, HW), generator=g,
                            device=dev).to(dtypes[ld])
        lab.view(-1)[::97] = NC  # outside the classes
        cw = torch.ones(NC, device=dev)
        stats = k89.dice_ce_stats(x, lab, cw)
        coef = k89.loss_coefficients(stats, torch.ones((), device=dev), NC,
                                     1.0, True, cw)
        P = N * HW * HW
        got = runner("kernel", x, lab, coef)().clone()
        old = runner("kernel", x, lab, coef, old=True)().clone()
        pkg = k89.dice_ce_bwd(x, lab, coef)
        torch.cuda.synchronize()
        same = (torch.equal(got, old), torch.equal(got, pkg))
        print(f"{xd} logits, {ld} labels: kernel bit-equal to the body it "
              f"replaced {same[0]}, to the package's wrapper {same[1]} "
              f"({int((got != old).sum())} of {got.numel()} differ)",
              flush=True)
        for name in ("stages3", "blocks6"):
            same += (torch.equal(runner(name, x, lab, coef)(), got),)
        torch.cuda.synchronize()
        if not all(same):
            raise RuntimeError(f"K9 probe: the builds disagree {same}")
        nbytes = 2 * x.numel() * x.element_size() + P * lab.element_size() \
            + 4 * 3 * NC
        bound = nbytes / HBM * 1e3
        print(f"  bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB); plan "
              f"{plan_of(libs['kernel'], x, lab)}", flush=True)
        for name, o in (("kernel", False), ("one_thread_a_pixel", True),
                        ("copies", False), ("no_stores", False),
                        ("maxc16", False), ("stages3", False),
                        ("blocks6", False)):
            ms = device_ms(runner("kernel" if o else name, x, lab, coef, o))
            print(f"  {name:18s} device {ms:.4f} ms ({nbytes / ms / 1e6:.0f} "
                  f"GB/s, {100 * bound / ms:.1f}% of the bound's rate)",
                  flush=True)
        del x, lab, got, old, pkg
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
