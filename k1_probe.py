#!/usr/bin/env python3
"""Where K1's time goes on the card: the served U-Net's int8 3x3 conv on its
tensor-core body (``csrc/conv3x3_int8.cu:conv3x3_int8_mma``) built as it is
and with parts of its work taken out, timed at the 17 non-stem calls of the
served forward (f=32, 512x512, batch 32), beside the dp4a body and the
body's other launches.

    python3 k1_probe.py        # from the repository root; needs one card

Builds (each by its own nvcc, into a temporary directory with its own copy
of ``csrc/mma_int8.cuh``; the unmodified one with ``-Xptxas -v``, whose
register and spill lines for the mma.sync body are printed):
- ``kernel``: the source as it is (checked bit-equal to the plain version
  at each call, batch 2, before anything is timed);
- ``no_copies``: every cp.async reads no byte and zero-fills its unit (the
  ring, the border fills, the barriers, the products and the epilogue
  stay);
- ``no_products``: the K chunks' ldmatrix and mma.sync are skipped (the
  copies, barriers and the epilogue stay);
- ``no_epilogue``: the requant, the shared-memory tiles and the stores of
  y and the pooled values are skipped.

Prints the card's name and power limit, then per call the device time
(``torch.profiler``: the mean of the launches it recorded in three
windows of 10 calls; weights packed once, outside the timed calls) of
each build at the plan's launch, of the unmodified build at the other
launches the body takes (32 or 64 output channels, 8 or 4 warps a block,
where cout allows them), and of the dp4a body; then the sums over the 17
calls.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

F = 32
COPY = '"r"(ok ? 16 : 0)'
PRODUCTS = "        mma_chunk<MW, NT, PITCH>("
EPILOGUE = "    epilogue<NT, WARPS, HEAD>(acc, k1_smem"


def calls(f=F, hw=512, n=32):
    """The 17 non-stem K1 calls of the served forward: (name, N, H, cins,
    cout, pool), as chip_smoke.stages lists them."""
    out = [("blk0_conv1", n, hw, (f,), f, True)]
    h, c = hw // 2, f
    for i in range(1, 4):
        out += [(f"blk{i}_conv0", n, h, (c,), 2 * c, False),
                (f"blk{i}_conv1", n, h, (2 * c,), 2 * c, True)]
        h, c = h // 2, 2 * c
    out += [("blk4_conv0", n, h, (c,), 2 * c, False),
            ("blk4_conv1", n, h, (2 * c,), 2 * c, False)]
    c *= 2
    for blk in (5, 6, 7, 8):
        h, c = 2 * h, c // 2
        out += [(f"blk{blk}_conv0", n, h, (c, c), c, False),
                (f"blk{blk}_conv1", n, h, (c,), c, False)]
    return out


def builds(src: str, header: str) -> dict[str, tuple[str, str]]:
    """name -> (K1's source, the shared header csrc/mma_int8.cuh)."""
    for text, line in ((header, COPY), (src, PRODUCTS), (src, EPILOGUE)):
        if text.count(line) != 1:
            raise RuntimeError("k1_probe: the K1 sources no longer have the "
                               f"line this probe edits: {line!r}")
    # a run-time condition that never holds: the code stays compiled
    return {"kernel": (src, header),
            "no_copies": (src, header.replace(COPY, '"r"(0)')),
            "no_products": (src.replace(PRODUCTS, "        if (cout < 0) "
                                        + PRODUCTS.lstrip()), header),
            "no_epilogue": (src.replace(EPILOGUE, "    if (cout < 0) "
                                        + EPILOGUE.lstrip()), header)}


def ptxas_lines(out: str) -> list[str]:
    """ptxas's lines for the mma.sync body's entry functions."""
    keep, entry = [], ""
    for line in out.splitlines():
        if "Compiling entry function" in line:
            entry = line
        if "conv3x3_int8_mma" in entry and (
                "Compiling entry" in line or "Used" in line
                or "spill" in line):
            keep.append(line.strip())
    return keep


def main() -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        conv_int8 as k12,
    )

    if not torch.cuda.is_available():
        print("k1_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
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
            for entry in ("octseg_conv3x3_int8_mma", "octseg_conv3x3_int8"):
                fn = getattr(lib, entry)
                fn.argtypes = _build.SIGNATURES[entry]
                fn.restype = ctypes.c_int
            libs[name] = lib

    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    stream = torch.cuda.current_stream().cuda_stream

    def args(n, h, cins, cout):
        xs = tuple(torch.tensor(gen.integers(0, 128, (n, h, h, c)),
                                dtype=torch.int8, device=dev) for c in cins)
        wq = torch.tensor(gen.integers(-127, 128, (cout, sum(cins), 3, 3)),
                          dtype=torch.int8, device=dev)
        std = (9 * sum(cins)) ** 0.5 * 64 * 73
        scale = torch.tensor(gen.uniform(30, 60, cout) / std,
                             dtype=torch.float32, device=dev)
        bias = torch.tensor(gen.uniform(-5, 5, cout), dtype=torch.float32,
                            device=dev)
        return xs, wq, scale, bias

    def runner(lib, xs, wq, scale, bias, pool, plan):
        """One launch of ``plan``'s body from ``lib``, weights packed once."""
        N, H, W, cin0 = xs[0].shape
        x1 = xs[1].data_ptr() if len(xs) > 1 else None
        cin1 = xs[1].shape[-1] if len(xs) > 1 else 0
        cout = scale.shape[0]
        y = torch.empty((N, H, W, cout), dtype=torch.int8, device=dev)
        yp = torch.empty((N, H // 2, W // 2, cout), dtype=torch.int8,
                         device=dev) if pool else None
        epi = (1, 0, 0, 127.0, 1.0, 0.0, 127.0, None, None, None, 0, None)
        if plan.body == "mma":
            wm = k12.pack_conv3x3_mma_weights(wq)

            def run():
                _build.check(lib.octseg_conv3x3_int8_mma(
                    xs[0].data_ptr(), cin0, x1, cin1, wm.data_ptr(),
                    scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                    yp.data_ptr() if pool else None, N, H, W, cout, *epi,
                    plan.co_t, plan.warps, plan.nk, plan.stages, plan.smem,
                    stream),
                    "K1 probe")
                return (y, yp) if pool else (y,)
        else:
            wk = k12.pack_conv3x3_weights(wq)

            def run():
                _build.check(lib.octseg_conv3x3_int8(
                    xs[0].data_ptr(), cin0, x1, cin1, wk.data_ptr(),
                    scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
                    yp.data_ptr() if pool else None, N, H, W,
                    4 * wk.shape[1], cout, wk.shape[2], *epi, stream),
                    "K1 probe")
                return (y, yp) if pool else (y,)
        return run

    def device_ms(run, runs=10):
        """The mean duration of the launches the profiler recorded over
        three windows of ``runs`` calls (one kernel a call). The profiler
        drops kernel events, more the longer the process has run; those
        it keeps carry their full durations."""
        run()
        torch.cuda.synchronize()
        us = count = 0
        for _window in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(runs):
                    run()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == DeviceType.CUDA:
                    us += e.self_device_time_total
                    count += e.count
        return us / count / 1e3 if count else float("nan")

    def plans(n, h, cins, cout):
        """The plan's launch (first), the body's other launches (N32w8 =
        32 output channels and 8 warps a block, ...), and the dp4a body."""
        plan = k12.conv3x3_plan(n, h, h, cins, cout)
        out = {f"N{plan.co_t}w{plan.warps}": plan}
        for co_t, warps in ((32, 8), (32, 4), (64, 8)):
            label = f"N{co_t}w{warps}"
            if cout % co_t == 0 and label not in out:
                out[label] = k12.plan_for(n, h, h, cins, cout, False, co_t,
                                          warps)
        out["dp4a"] = plan._replace(body="dp4a")
        return out

    for name, n, h, cins, cout, pool in calls():
        a = args(2, h, cins, cout)
        want = k12.conv3x3_int8_reference(
            a[0], k12.pack_conv3x3_weights(a[1]), a[2], a[3], pool=pool)
        want = want if pool else (want,)
        for label, plan in plans(2, h, cins, cout).items():
            got = runner(libs["kernel"], *a, pool, plan)()
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"K1 {label} differs from its plain "
                                   f"version at {name}")
    sums: dict[str, float] = {}
    for name, n, h, cins, cout, pool in calls():
        a = args(n, h, cins, cout)
        ps = plans(n, h, cins, cout)
        times = {label: device_ms(runner(libs["kernel"], *a, pool, plan))
                 for label, plan in ps.items()}
        chosen = next(iter(ps.values()))
        for b in ("no_copies", "no_products", "no_epilogue"):
            times[b] = device_ms(runner(libs[b], *a, pool, chosen))
        times["plan"] = times[next(iter(ps))]
        for k, v in times.items():
            sums[k] = sums.get(k, 0.0) + v
        print(f"{name:11s} {h}^2 {cins}->{cout} batch {n} (plan N "
              f"{chosen.co_t}, {chosen.warps} warps, {chosen.stages} "
              f"stages): " + ", ".join(
                  f"{b} {t:.4f} ms" for b, t in times.items() if b != "plan"),
              flush=True)
        del a
        torch.cuda.empty_cache()
    print("17 calls summed: " + ", ".join(
        f"{b} {t:.4f} ms" for b, t in sums.items()
        if b in ("plan", "dp4a", "no_copies", "no_products", "no_epilogue")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
