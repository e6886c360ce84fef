#!/usr/bin/env python3
"""The packed U-Net train step (f=32, 10 classes, 512², batch 32, Adam
1e-3, Dice + CE) on one card: where its device time goes by the program's
spans and by kernel, and what the profiler costs the host, with the step
on one input held on the card and fed from the host as the trainer feeds
it.

    python3 step_probe.py      # from the repository root; needs one card

Each run takes ``STEPS`` steps, ``float(loss)`` after every step as the
trainer does, and reads the step period and the host's time a step until
``step`` returns (the enqueue; ``float(loss)`` then waits for the card).

1. One input on the card: untraced; with the program's tracing on
   (``profiling.tracing()``: its spans and counters) and no profiler; and
   under ``torch.profiler`` with tracing on, as a ``--trace 1`` run of the
   benchmark profiles (``profiling.all_threads()``).
2. Fed: float32 images and int64 labels of 32 rows on the host (two
   batches, in turns) through ``training/input_pipeline.prefetch_to_device``,
   which pins and copies each batch in its producer thread, cast to bf16
   there; untraced, then under the profiler with tracing on.

For each profiled run, through ``octbench/program_trace.program_summary``:
the device's busy ms a step, each span's host and device ms a step, and
the device's idle ms a step by the span open on the main thread during
it (``input.wait``: the step waits for its input); for the first, the
largest kernels. Where a traced run's step period exceeds the untraced
one's, the extra idle share reads the profiler's cost to the host, not the
program.
Last: the card's name and power limit, and the peak memory.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

STEPS = 10
BATCH = 32


def main() -> int:
    import torch
    from torch.autograd import DeviceType

    from octbench.program_trace import program_summary, thread_of
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
        OptimConfig,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
        UNet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
        packed_unet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.input_pipeline import (
        prefetch_to_device,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
        dice_ce_loss,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
        create_train_state,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils import (
        profiling,
    )

    if not torch.cuda.is_available():
        print("step_probe: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    model = UNet(1, 10, 32, generator=torch.Generator().manual_seed(0)).to(dev)
    state = create_train_state(model, OptimConfig(learning_rate=1e-3))
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((BATCH, 512, 512, 1), generator=gen, device=dev).to(
        torch.bfloat16)
    y = torch.randint(0, 10, (BATCH, 512, 512), generator=gen, device=dev)
    host_gen = torch.Generator().manual_seed(2)
    host = [(torch.randn((BATCH, 512, 512, 1), generator=host_gen),
             torch.randint(0, 10, (BATCH, 512, 512), generator=host_gen))
            for _ in range(2)]
    step = packed_unet.make_packed_train_step(dice_ce_loss)
    for _ in range(3):
        float(step(state, x, y))
    torch.cuda.synchronize()

    def on_card():
        """-> (step period ms by CUDA events, host ms a step until
        ``step`` returns), one input on the card."""
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        enqueue = 0.0
        e0.record()
        for _ in range(STEPS):
            t0 = time.perf_counter()
            loss = step(state, x, y)
            enqueue += time.perf_counter() - t0
            float(loss)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / STEPS, enqueue / STEPS * 1e3

    def fed():
        """-> a run fed from the host through the prefetcher, started and
        its first batch taken; the run -> (step period ms by the host's
        clock, host ms a step until ``step`` returns)."""
        batches = prefetch_to_device(
            iter(host * (STEPS // 2 + 1)), dev,
            transform=lambda b: (b[0].to(torch.bfloat16), b[1]))
        float(step(state, *next(batches)))
        torch.cuda.synchronize()

        def run():
            enqueue = 0.0
            t0 = time.perf_counter()
            for _ in range(STEPS):
                xb, yb = next(batches)
                t1 = time.perf_counter()
                loss = step(state, xb, yb)
                enqueue += time.perf_counter() - t1
                float(loss)
            period = (time.perf_counter() - t0) / STEPS * 1e3
            return period, enqueue / STEPS * 1e3
        return run

    def show(what, run):
        period, enqueue = run
        print(f"{what}: a step every {period:.3f} ms; host until step "
              f"returns {enqueue:.3f} ms a step", flush=True)

    def profiled(what, run):
        """``run`` under the profiler with tracing on; -> the profile."""
        with profiling.tracing(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA],
                experimental_config=profiling.all_threads()) as prof:
            show(f"{what}, under the profiler with tracing on", run())
        s = program_summary(prof, thread_of(prof, profiling.PREFIX
                                            + "step.forward"))

        def per_step(sec):
            return round(sec / STEPS * 1e3, 3)

        print(f"  device busy {per_step(s['busy_s'])} ms a step; outside "
              f"any span {per_step(s['outside_s'])}, linked to no call "
              f"{per_step(s['unlinked_s'])}")
        print("  spans, ms a step (host, device):", json.dumps(
            {k: [per_step(v["host_s"]), per_step(v["device_s"])]
             for k, v in s["spans"].items()}))
        print("  idle by the span open, ms a step:", json.dumps(
            {k: per_step(v) for k, v in s["idle_by_span"].items()}),
            flush=True)
        return prof

    show("one input on the card, untraced", on_card())
    with profiling.tracing():
        show("one input on the card, tracing on, no profiler", on_card())
    prof = profiled("one input on the card", on_card)
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:22]:
        print(f"  {e.self_device_time_total / STEPS / 1e3:8.3f} ms "
              f"x{e.count / STEPS:5.1f}  {e.key[:140]}")
    show("fed from the host, untraced", fed()())
    profiled("fed from the host", fed())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
