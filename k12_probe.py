#!/usr/bin/env python3
"""Where K12's time goes on the card: SDNet's column softmax, position and
std (``csrc/column_softargmax.cu:column_softargmax_regs``) built as it is
and with parts of its work taken out, beside the three-pass body it
replaced for H <= 512, timed at SDNet's shapes (8, 3, 512, 512) and
(8, 11, 512, 512), and the train step's (4, 3, 512, 512).

    python3 k12_probe.py       # from the repository root; needs one card

Builds (each by its own nvcc with ``-Xptxas -v``, into a temporary
directory):
- ``kernel``: the source as it is, with an entry point appended that
  launches the three-pass body at any H
  (``octseg_column_softargmax_three_pass``) and one that reports a body's
  blocks an SM (the occupancy API). The register body is checked
  bit-equal to the package's wrapper, and both bodies against the float64
  plain version within phase 22's limits, at every shape;
- ``loads``: the register body's loads alone (each thread's R values
  summed into a checksum that is stored only if it equals -1; no max,
  exponentials, sums or stores);
- ``no_sm_stores``: the register body without its sm stores (pos and std
  still written);
- ``rcp_div``: the register body with its IEEE division ``e / sum``
  replaced by ``q = e * rs`` and one FMA residual step, ``rs = RN(1 /
  sum)`` (no slow-path call); its sm is compared with the kernel's
  element by element (column 4 of the first plane holds logits from -104
  to 0, whose quotients reach the subnormal range).

Prints the card's name and power limit, each build's registers and
spills (ptxas) and the register body's blocks an SM, then per shape the
byte bound (x read once, sm written once, pos and std) and the device
time of one call of each (``torch.profiler``: each kernel's mean recorded
duration over two windows of 10 calls) with its share of the bound's
rate.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

from k3_probe import device_ms, ptxas_lines

HBM = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
SHAPES = [(8, 3, 512, 512), (8, 11, 512, 512), (4, 3, 512, 512)]
LOADS_END = "    float m = v[0];\n"
SM_STORE = "        if (row(r)) sp[o0 + r * step] = v[r];\n"
DIVISION = "        v[r] = v[r] / sum;\n"
RCP_DIVISION = ("        {\n"
                "            const float rs = __frcp_rn(sum), q = v[r] * rs;\n"
                "            v[r] = fmaf(fmaf(-q, sum, v[r]), rs, q);\n"
                "        }\n")
LOADS_ONLY = """    {  // the loads alone: a checksum, stored only if it is -1
        float c = 0.0f;
#pragma unroll
        for (int r = 0; r < R; ++r) c += v[r];
        if (live && c == -1.0f) pos[(size_t)blockIdx.y * W + w] = c;
        if (H > 0) return;
    }
"""
# entry points appended to every build: the three-pass body at any H, and
# a body's blocks an SM
EXTRA = r"""
extern "C" int octseg_column_softargmax_three_pass(
    const void* x, void* sm, void* pos, void* std_out, int planes, int H,
    int W, void* stream) {
    dim3 grid((W + COLS - 1) / COLS, planes);
    dim3 block(COLS, RW);
    column_softargmax_three_pass<<<grid, block, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(sm),
        static_cast<float*>(pos), static_cast<float*>(std_out), H, W);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int octseg_column_softargmax_blocks_per_sm(int H, int W,
                                                     void* blocks) {
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        static_cast<int*>(blocks),
        reinterpret_cast<const void*>(body_for(H, W)), COLS * RW, 0));
}
"""


def builds(src: str) -> dict[str, str]:
    """name -> source (the extra entry points appended to each)."""
    for line in (LOADS_END, SM_STORE, DIVISION):
        if src.count(line) != 1:
            raise RuntimeError("k12_probe: the K12 source no longer has the "
                               f"line this probe edits: {line!r}")
    # a run-time condition that never holds: the store stays compiled
    no_stores = src.replace(SM_STORE, SM_STORE.replace("row(r)",
                                                       "row(r) && H < 0"))
    return {name: text + EXTRA for name, text in (
        ("kernel", src), ("loads", src.replace(LOADS_END,
                                               LOADS_ONLY + LOADS_END)),
        ("no_sm_stores", no_stores),
        ("rcp_div", src.replace(DIVISION, RCP_DIVISION)))}


def main() -> int:
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        column_softargmax as k12,
    )

    if not torch.cuda.is_available():
        print("k12_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    src = (_build.CSRC / "column_softargmax.cu").read_text()
    sig = _build.SIGNATURES["octseg_column_softargmax"]
    libs = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs = {}
        for name, text in builds(src).items():
            d = Path(tmp) / name
            d.mkdir()
            cu, so = d / "column_softargmax.cu", d / "k12.so"
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
            for fn, argtypes in (
                    ("octseg_column_softargmax", sig),
                    ("octseg_column_softargmax_three_pass", sig),
                    ("octseg_column_softargmax_blocks_per_sm",
                     [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            libs[name] = lib

    for H, W in ((128, 64), (256, 64), (512, 512), (500, 45), (600, 96)):
        n = ctypes.c_int(0)
        _build.check(libs["kernel"].octseg_column_softargmax_blocks_per_sm(
            H, W, ctypes.addressof(n)), "K12 probe occupancy")
        print(f"H={H}, W={W}: "
              f"{k12.column_softargmax_plan(1, 1, H, W).text()}, "
              f"{n.value} blocks an SM", flush=True)

    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator(device=dev).manual_seed(0)

    def runner(name, x, three_pass=False):
        lib = libs[name]
        B, L, H, W = x.shape
        sm = torch.empty_like(x)
        pos = torch.empty((B, L, W), dtype=torch.float32, device=dev)
        std = torch.empty_like(pos)
        fn = lib.octseg_column_softargmax_three_pass if three_pass \
            else lib.octseg_column_softargmax

        def run():
            _build.check(fn(x.data_ptr(), sm.data_ptr(), pos.data_ptr(),
                            std.data_ptr(), B * L, H, W, stream),
                         f"K12 probe {name}")
            return sm, pos, std
        return run

    for shape in SHAPES:
        B, L, H, W = shape
        x = torch.randn(shape, generator=g, device=dev) * 3
        x[0, 0, :, 4] = torch.linspace(-104.0, 0.0, H, device=dev)
        want = k12.column_softargmax_reference(x)
        got = [t.clone() for t in runner("kernel", x)()]
        old = [t.clone() for t in runner("kernel", x, three_pass=True)()]
        pkg = k12.column_softargmax_forward(x)
        torch.cuda.synchronize()
        lims = (1e-6, 1e-5 * H, 1e-5 * H)
        errs = [[float((a - b).abs().max()) for a, b in zip(out, want)]
                for out in (got, old)]
        same = all(torch.equal(a, b) for a, b in zip(got, pkg))
        rcp = runner("rcp_div", x)()[0]
        differ = got[0] != rcp
        print(f"{shape}: sm elements where rcp_div's quotient differs from "
              f"the IEEE division's {int(differ.sum())}, the largest "
              f"{float(got[0][differ].abs().max()) if differ.any() else 0:.3e}",
              flush=True)
        print(f"{shape}: register body bit-equal to the package's wrapper "
              f"{same}; max abs error vs float64 (sm, pos, std): register "
              f"body {errs[0]}, three-pass body {errs[1]} (limits {lims})",
              flush=True)
        if not same or any(e > t for es in errs for e, t in zip(es, lims)):
            raise RuntimeError("K12 probe: a body disagrees")
        n = B * L * H * W
        nbytes = 8 * n + 8 * B * L * W
        bound = nbytes / HBM * 1e3
        print(f"  bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB); plan "
              f"{k12.column_softargmax_plan(*shape).text()}", flush=True)
        for name, three in (("kernel", False), ("three_pass", True),
                            ("loads", False), ("no_sm_stores", False),
                            ("rcp_div", False)):
            ms = device_ms(runner("kernel" if three else name, x, three))
            print(f"  {name:13s} device {ms:.4f} ms ({nbytes / ms / 1e6:.0f} "
                  f"GB/s, {100 * bound / ms:.1f}% of the bound's rate)",
                  flush=True)
        del x, want, got, old, pkg
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
