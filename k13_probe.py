#!/usr/bin/env python3
"""K13 and K14 on the card against their byte bound: the training
BatchNorm's normalize and ReLU (``csrc/bn_apply.cu:bn_apply_kernel``) and
its dx (``bn_dx_kernel``) at the packed U-Net step's 18 BatchNorm shapes
(512², f=32, batch 32, bf16: four each of 512²x32, 256²x64, 128²x128 and
64²x256, two of 32²x512), beside the eager passes they replaced, and K6
in its masked mode beside K6 over relu's zeroed gradient.

    python3 k13_probe.py       # from the repository root; needs one card

Prints the card's name and power limit, the registers and spills of the
instances of ``bn_apply.cu`` and ``bn_pair_sums.cu`` (ptxas, a build of
their own into a temporary directory) and the blocks an SM the package's
build holds of each instance it launches here; then per shape the bytes
and byte bound of K13 (x read, y written: 4 bytes an element) and K14 (dy
and x read, dx written: 6), the device time of one call of each
(``torch.profiler``, as ``k3_probe.device_ms``) and its share of the
bound's rate, the plain passes' device time (forward: the fp32 normalize,
its cast and ``torch.relu``; backward: ``threshold_backward`` and the fp32
dx with its casts), the masked K6 and K6 over the zeroed dy; and the sums
over the 18 BatchNorms. Every kernel is first checked bit-equal to its
plain version at the shape.

    python3 k13_probe.py --block   # the zoo's BatchNorm block alone

``--block`` times the zoo's channels-first BatchNorm
(``models/blocks.BatchNorm`` in train mode, on the NCHW map a zoo model
hands it) followed by a 3x3 conv of the library, forward and backward, at
``BLOCK_SHAPES``: device time (as above) and event time a call. It uses
nothing but that block, so it runs on a tree from before K13 and K14 too
(copy this file and ``k3_probe.py`` there), where the block ran the plain
passes on its channels-last view.
"""

from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

from k3_probe import device_ms, ptxas_lines

HBM = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA data sheet)
# (N, H, W, C) and how many of the step's 18 BatchNorms have that shape
SHAPES = [((32, 512, 512, 32), 4), ((32, 256, 256, 64), 4),
          ((32, 128, 128, 128), 4), ((32, 64, 64, 256), 4),
          ((32, 32, 32, 512), 2)]
# (N, C, H, W) and dtype of the ``--block`` runs: zoo-sized maps
BLOCK_SHAPES = [((8, 32, 512, 512), "float32"), ((8, 128, 128, 128), "float32"),
                ((8, 32, 512, 512), "bfloat16")]


def block() -> int:
    """``--block``: the zoo's BatchNorm and a 3x3 conv after it."""
    import statistics

    import torch
    import torch.nn.functional as F

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.blocks import (
        BatchNorm,
    )

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for shape, dtype in BLOCK_SHAPES:
        dt = getattr(torch, dtype)
        c = shape[1]
        bn = BatchNorm(c).to(dev).train()
        w = (torch.randn((c, c, 3, 3), generator=gen, device=dev)
             * 0.05).to(dt).requires_grad_()
        x = (torch.randn(shape, generator=gen, device=dev) * 2
             + 0.5).to(dt).requires_grad_()
        dy = torch.randn(shape, generator=gen, device=dev).to(dt)

        def call():
            out = F.conv2d(bn(x), w, padding=1)
            torch.autograd.backward(out, dy)

        dms = device_ms(call, runs=5)
        times = []
        for _ in range(10):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            call()
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        print(f"BatchNorm (train) + 3x3 conv, {'x'.join(map(str, shape))} "
              f"{dtype}, forward and backward: device {dms:.4f} ms, event "
              f"{statistics.median(times):.4f} ms", flush=True)
        del bn, w, x, dy
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        fused_bn as k6,
    )

    if not torch.cuda.is_available():
        print("k13_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        for src in ("bn_apply.cu", "bn_pair_sums.cu"):
            done = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                 "-o", str(Path(tmp) / "probe.o"), str(_build.CSRC / src)],
                capture_output=True, text=True)
            if done.returncode != 0:
                raise RuntimeError(f"nvcc failed for {src}:\n{done.stderr}")
            print(f"{src}:", *ptxas_lines(done.stdout + done.stderr),
                  sep="\n", flush=True)

    dev = torch.device("cuda")
    index = torch.cuda.current_device()
    for dx in (False, True):
        print(f"{'K14' if dx else 'K13'} bf16 vec 8 relu: "
              f"{k6._apply_co_resident(index, dx, True, 8, True)} blocks "
              f"on the card at once")
    print(f"K6 bf16 vec 8 backward: unmasked "
          f"{k6._co_resident(index, True, True, 8)}, masked "
          f"{k6._co_resident(index, True, True, 8, True)} blocks "
          "(the masked plan takes the lesser)", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    total = dict.fromkeys(("k13", "k14", "plain_fwd", "plain_bwd", "k6_masked",
                           "k6", "bound13", "bound14"), 0.0)
    for shape, count in SHAPES:
        c = shape[-1]
        m = shape[0] * shape[1] * shape[2]
        x = (torch.randn(shape, generator=gen, device=dev) * 2
             + 0.5).to(torch.bfloat16)
        dy = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        scale = torch.rand(c, generator=gen, device=dev) + 0.5
        shift = torch.randn(c, generator=gen, device=dev)
        g, c1, c0 = (torch.randn(c, generator=gen, device=dev) * 0.1
                     for _ in range(3))
        mask = (scale, shift)
        y = k6.bn_apply_reference(x, scale, shift, True)
        dym = torch.ops.aten.threshold_backward(dy, y, 0)
        checks = {
            "K13": (k6.bn_apply(x, scale, shift, True), y),
            "K14": (k6.bn_dx(dy, x, g, c1, c0, mask),
                    k6.bn_dx_reference(dym, x, g, c1, c0)),
            "K6 masked": (k6.pair_sums(dy, x, mask=mask),
                          k6.pair_sums(dym, x)),
        }
        for name, (got, want) in checks.items():
            if not torch.equal(got, want):
                raise RuntimeError(f"k13_probe: {name} differs from its plain "
                                   f"version at {shape}")

        def plain_bwd():
            d = torch.ops.aten.threshold_backward(dy, y, 0)
            return k6.bn_dx_reference(d, x, g, c1, c0)

        ms = {
            "k13": device_ms(lambda: k6.bn_apply(x, scale, shift, True)),
            "k14": device_ms(lambda: k6.bn_dx(dy, x, g, c1, c0, mask)),
            "plain_fwd": device_ms(
                lambda: k6.bn_apply_reference(x, scale, shift, True)),
            "plain_bwd": device_ms(plain_bwd),
            "k6_masked": device_ms(lambda: k6.pair_sums(dy, x, mask=mask)),
            "k6": device_ms(lambda: k6.pair_sums(dym, x)),
        }
        ms["bound13"] = 4 * m * c / HBM * 1e3
        ms["bound14"] = 6 * m * c / HBM * 1e3
        for k, v in ms.items():
            total[k] += count * v
        print(f"{'x'.join(map(str, shape))} bf16 (x{count}): "
              f"K13 {ms['k13']:.4f} ms ({100 * ms['bound13'] / ms['k13']:.1f}% "
              f"of the bound's rate, bound {ms['bound13']:.4f}; plan "
              f"{k6._apply_launch(x, x, backward=False, relu=True).text()}), "
              f"K14 {ms['k14']:.4f} ms ({100 * ms['bound14'] / ms['k14']:.1f}%,"
              f" bound {ms['bound14']:.4f}); plain forward "
              f"{ms['plain_fwd']:.4f}, plain backward {ms['plain_bwd']:.4f}; "
              f"K6 masked {ms['k6_masked']:.4f}, K6 on the zeroed dy "
              f"{ms['k6']:.4f}", flush=True)
        del x, dy, y, dym, checks
        torch.cuda.empty_cache()
    print(f"the step's 18 BatchNorms: K13 {total['k13']:.4f} ms "
          f"({100 * total['bound13'] / total['k13']:.1f}% of the bound's "
          f"rate, bound {total['bound13']:.4f}), K14 {total['k14']:.4f} ms "
          f"({100 * total['bound14'] / total['k14']:.1f}%, bound "
          f"{total['bound14']:.4f}); plain forward {total['plain_fwd']:.4f}, "
          f"plain backward {total['plain_bwd']:.4f}; K6 masked "
          f"{total['k6_masked']:.4f}, K6 on the zeroed dy {total['k6']:.4f}",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(block() if sys.argv[1:] == ["--block"] else main())
