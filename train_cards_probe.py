#!/usr/bin/env python3
"""``cli train --packed`` over every card of the host (one rank a card over
NCCL, each on its shard of every batch) against the same command on one
card (``--device cuda:0``), with the unfused and the fused loss; then
``eval --checkpoint`` on the file the ranks wrote.

    python3 train_cards_probe.py     # on a host with two or more cards

U-Net f=32, 10 classes, 512x512 synthetic B-scans, one epoch of one step
at a global batch of 8 from the seeded weights. The step's gradients are
read back from Adam's first moment (after one step ``exp_avg`` is
``(1 - b1) * g``), so the command's step on all cards is held against its
step on one card with ``chip_smoke.py``'s readings (``dp_agreement``):
relative loss, lowest gradient cosine and largest change of a gradient's
norm (over the tensors whose gradient norm is above 1e-3,
``chip_smoke.agreement``'s rule), and the running statistics. The limits
(``CARDS_GATE``) sit between the one-ulp floor, printed (one card, one
bf16 ulp added to 1e-4 of the step's input pixels), and two planted
faults run over the same NCCL ranks, which must fail them: K6's sums left
unreduced (unfused loss) and K8's statistics left unreduced (fused loss).

It also prints the largest relative difference of a parameter after the
step, its tensor and the gradient of that element on all cards and on
one: Adam's first step moves a weight by ``lr * g / (|g| + eps)``, about
``lr * sign(g)``, so an element whose gradient is near zero against its
tensor's moves by up to ``2 * lr`` between two runs whose gradients differ
by rounding.

Prints the card's name and power limit and the readings; exits non-zero
on fewer than two cards, on more or fewer than one checkpoint, on a step
or the floor outside the gate, on a fault inside it, or on an evaluation
that does not count every pixel.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import chip_smoke

BATCH = 8
ARGS = ["train", "--packed", "--image-size", "512", "--num-classes", "10",
        "--batch-size", str(BATCH), "--num-train", str(BATCH), "--num-val",
        str(BATCH), "--epochs", "1", "--model-kwargs",
        json.dumps({"init_features": 32})]
# all cards against one card from the seeded weights, between the one-ulp
# floor and the planted faults (four H100s): the floor reads relative loss
# 1.4e-07, lowest cosine 0.9859 (bottleneck.bottleneckconv1.weight), norm
# change 5.0e-03, statistics 1.2e-04; K6 unreduced 7.9e-06 / 0.905 /
# 1.3e-02 / 2.0e-02, K8 unreduced 4.3e-03 / 0.9925 / 3.01 / 8.4e-05.
# PACKED_DP_GATE's loss and statistics limits hold here; its cosine and
# norm limits, set at phase 7's trained state, sit above this floor
CARDS_GATE = {**chip_smoke.PACKED_DP_GATE, "cosine": 0.96, "norm": 8e-3}
# planted faults, each run over the host's cards with its loss
FAULTS = {"K6 sums unreduced (per-rank BN statistics)": (
              "0", "fused_bn", lambda sums, m, group: (sums, m)),
          "K8 statistics unreduced (per-rank loss)": (
              "1", "dice_ce", lambda stats, group: stats)}
OPS = "retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops."


def first_step(state, loss):
    """(loss, {name: gradient}, {name: running statistic}) of a train state
    after one Adam step, on the host in float64."""
    b1 = state.optimizer.param_groups[0]["betas"][0]
    moments = state.optimizer.state
    grads = {n: (moments[p]["exp_avg"] / (1 - b1)).detach().cpu().double()
             for n, p in state.model.named_parameters()}
    stats = {k: v.detach().cpu().double()
             for k, v in state.model.state_dict().items() if "running" in k}
    return loss, grads, stats


def params(state):
    return {n: p.detach().cpu().double()
            for n, p in state.model.named_parameters()}


def largest_parameter_difference(a, b, ga, gb):
    """The largest |a - b| / max |b| over the parameters of two steps, its
    tensor, and that element's gradient in each step."""
    worst = (0.0, "", 0)
    for n, p in b.items():
        d = (a[n] - p).abs().flatten()
        i = int(d.argmax())
        worst = max(worst, (float(d[i] / p.abs().max().clamp_min(1e-30)),
                            n, i))
    rel, n, i = worst
    return rel, n, float(ga[n].flatten()[i]), float(gb[n].flatten()[i])


def read_log(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def fault_rank(argv, label):
    """One rank of ``argv``'s ``train`` inside ``run_ranks``' NCCL group
    (its ``local_mesh``), on this rank's card, with ``label``'s fault
    planted. -> rank 0's first step (its loss None: read from the log)."""
    import importlib

    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli

    _, module, fn = FAULTS[label]
    with chip_smoke.swapped(importlib.import_module(OPS + module),
                            _global=fn):
        state = cli.main([*argv, "--device",
                          f"cuda:{torch.cuda.current_device()}"])
    return None if torch.distributed.get_rank() else first_step(state, None)


def main() -> int:
    import torch

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.launch import (
        run_ranks,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
        Trainer,
    )

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < 2:
        print(f"train_cards_probe: {cards} card(s); needs two or more",
              file=sys.stderr)
        return 1
    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    print(f"{cards} cards, torch {torch.__version__}", flush=True)
    _build.lib()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    step_fn = Trainer.train_step_fn

    def ulp_step_fn(self):
        step = step_fn(self)
        return lambda state, images, labels: step(
            state, chip_smoke.one_ulp_change(images, images.device).to(
                images.dtype), labels)

    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        for fused in ("0", "1"):
            os.environ["OCTSEG_PACKED_FUSED_LOSS"] = fused
            runs = {}
            for run, device in (("all cards", "cuda"), ("one card", "cuda:0"),
                                ("floor", "cuda:0")):
                d = os.path.join(tmp, f"{fused}_{run.replace(' ', '_')}")
                log = os.path.join(d, "log.jsonl")
                t = time.time()
                with chip_smoke.swapped(Trainer, train_step_fn=(
                        ulp_step_fn if run == "floor" else step_fn)):
                    state = cli.main([*ARGS, "--device", device,
                                      "--checkpoint-dir", d, "--log-file",
                                      log])
                recs = read_log(log)
                files = sorted(f for f in os.listdir(d) if f.endswith(".pt"))
                print(f"fused={fused} {run} (--device {device}): "
                      f"{time.time() - t:.1f} s, steps {state.step}, records "
                      f"{recs}, checkpoints {files}", flush=True)
                if len(recs) != 1 or len(files) != 1 or state.step != 1:
                    bad.append(f"fused={fused} {run}: records, files or "
                               "steps")
                runs[run] = (first_step(state, recs[-1]["train_loss"]),
                             params(state), recs[-1],
                             os.path.join(d, files[0]))
                del state
            one = runs["one card"][0]
            for run in ("all cards", "floor"):
                agree = chip_smoke.dp_agreement(runs[run][0], one)
                print(f"fused={fused}: {run} vs one card: "
                      f"{chip_smoke.dp_reading(agree)}; val_loss "
                      f"{runs[run][2]['val_loss']:.6f} / "
                      f"{runs['one card'][2]['val_loss']:.6f}", flush=True)
                if not gate_passes(agree):
                    bad.append(f"fused={fused}: {run} outside CARDS_GATE")
            for label, (f, _, _) in FAULTS.items():
                if f != fused:
                    continue
                d = os.path.join(tmp, f"{fused}_fault")
                log = os.path.join(d, "log.jsonl")
                got = run_ranks(fault_rank, cards,
                                [*ARGS, "--checkpoint-dir", d, "--log-file",
                                 log], label, backend="nccl")[0]
                agree = chip_smoke.dp_agreement(
                    (read_log(log)[-1]["train_loss"],) + got[1:], one)
                print(f"fused={fused}: planted fault, {label}, {cards} cards "
                      f"vs one card: {chip_smoke.dp_reading(agree)}",
                      flush=True)
                if gate_passes(agree):
                    bad.append(f"CARDS_GATE passes {label}")
            rel, leaf, ga, gb = largest_parameter_difference(
                runs["all cards"][1], runs["one card"][1],
                runs["all cards"][0][1], one[1])
            print(f"fused={fused}: largest relative parameter difference "
                  f"after the step {rel:.3e} ({leaf}; that element's "
                  f"gradient {ga:.3e} on {cards} cards, {gb:.3e} on one; "
                  f"the tensor's largest |gradient| "
                  f"{float(one[1][leaf].abs().max()):.3e})", flush=True)
            m = cli.main(["eval", "--model", "unet", "--num-classes", "10",
                          "--image-size", "512", "--batch-size", str(BATCH),
                          "--num-val", str(BATCH), "--device", "cuda:0",
                          "--model-kwargs", json.dumps({"init_features": 32}),
                          "--checkpoint", runs["all cards"][3]])
            pixels = int(m["confusion"].sum())
            print(f"eval --checkpoint of the {cards}-card run: confusion sum "
                  f"{pixels} (want {BATCH * 512 * 512})", flush=True)
            if pixels != BATCH * 512 * 512:
                bad.append(f"fused={fused}: eval")
            del runs, one
    print(f"gate: relative loss < {CARDS_GATE['loss']}, cosine > "
          f"{CARDS_GATE['cosine']}, norm change < {CARDS_GATE['norm']}, "
          f"running statistics < {CARDS_GATE['stats']}")
    print(f"total {time.time() - t0:.1f} s; "
          f"{'ok' if not bad else f'FAILED: {bad}'}", flush=True)
    return 1 if bad else 0


def gate_passes(agree):
    return chip_smoke.gate_passes(agree[:3], CARDS_GATE) and \
        agree[3] < CARDS_GATE["stats"]


if __name__ == "__main__":
    sys.exit(main())
