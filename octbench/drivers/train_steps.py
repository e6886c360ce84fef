"""Training steps as ``cli train --packed`` builds them, on one card or
data-parallel over several.

Each rank builds its trainer with the program's ``cli.build_training``
(``train --packed``, Adam, Dice + CE; under a process group of k ranks the
trainer's data axis is the group, as ``cmd_train`` starts it through
``parallel/launch.run_ranks`` with NCCL, a card a rank), loads the seeded
weights, and feeds its step as ``Trainer.fit`` does: a
``numpy_folder_dataset`` of seeded Duke-shaped rows on the host, at the
global batch, through ``prefetch_to_device`` with the trainer's
``_prepare``, ``float(loss)`` after every step, epochs cycled.

The first ``check_steps`` steps are the check's: the loss of each, the
first gradient (Adam's first moment after one step, divided by 1 - b1)
and the parameters after the last are kept. The window then goes on with
the same trainer, step and feed, and ends at the first step to finish
after ``seconds`` (on every rank at once). After it, the program's state
is freed, and the plain reference follows the same first steps on the same
rows from the same weights (over the same ranks, each on its block of
every global batch's rows), through the configuration's reference module
(``train_steps``); and the first BatchNorm's batch statistics of the first
step are worked out again from every row of its global batch at the
configuration's compute precision (the reference module's ``STEM``).
"""

from __future__ import annotations

import copy
import gc
import importlib
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from .. import data, harness, weights
from ..harness import PROGRAM
from ..reference.train import first_bn_stats, fp8_cast
from ..trace import Spans, summarize

# traffic keys: "chips", "batch_per_chip", "rows", "row_variety",
# "check_steps", "trace_seconds"
B1 = 0.9  # Adam's first-moment decay, as the configuration states it
# planted faults; the last two exist only over several ranks
FAULTS = ("unchanged", "half_batch", "no_exchange", "unreduced_stats")
# the numbers compared (``compare``'s readings) under their check names
CHECKS = {"loss_gap": "loss", "grad_norm_gap": "grad",
          "change_norm_gap": "change",
          "grad_cos_median_gap": "grad_cos_median",
          "bn_stats_gap": "stats", "stem_stats_gap": "stem_stats"}


def _train_args(cfg: dict, batch: int, device: str):
    cli = importlib.import_module(f"{PROGRAM}.cli")
    t = cfg["train"]
    argv = ["train", "--packed", "--model", cfg["model"], "--image-size",
            str(cfg["image_size"]), "--num-classes", str(cfg["num_classes"]),
            "--batch-size", str(batch), "--lr", str(t["learning_rate"]),
            "--optimizer", t["optimizer"], "--loss", t["loss"], "--dtype",
            t["compute_dtype"], "--device", device, "--model-kwargs",
            json.dumps({t["width_arg"]: cfg["width"]})]
    return cli, cli.parser().parse_args(argv)


def _leaf_norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def norm_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's |norm(prog) - norm(ref)| over the larger of the
    reference leaf's norm and the median leaf's."""
    rn, pn = _leaf_norms(ref), _leaf_norms(prog)
    names = [k for k in rn if keep is None or k in keep]
    med = float(np.median([rn[k] for k in names]))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def worst(gaps: dict) -> tuple[float, str]:
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf


def compare(prog: dict, ref: dict, p0: dict, stem: dict) -> dict:
    """Readings of the training check (``CHECKS`` names those compared):
    the worst step's relative loss gap; the first gradient's worst leaf by
    norm; the worst leaf of the parameters' change over the steps; the
    median leaf's 1 - cosine of the first gradient; the worst running-
    statistic buffer's first batch statistic; and the first BatchNorm's
    batch statistics (mean and variance as one vector) against ``stem``,
    their reference at the compute precision. The change and the cosines
    leave out the leaves whose reference gradient is under a thousandth of
    the median leaf's (Adam moves those by rounding alone)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                  ref["loss"]))
    grad, grad_leaf = worst(norm_gaps(prog["grad"], ref["grad"]))
    gn = _leaf_norms(ref["grad"])
    med = float(np.median(list(gn.values())))
    moved = {k for k, v in gn.items() if v >= 1e-3 * med}
    change, change_leaf = worst(norm_gaps(
        {k: prog["params"][k] - p0[k] for k in moved},
        {k: ref["params"][k] - p0[k] for k in moved}))
    stats, stats_leaf = worst(diff_gaps(prog["stats"], ref["stats"]))
    got = torch.cat([prog["stats"][k].double().reshape(-1) for k in stem])
    want = torch.cat([stem[k].double().reshape(-1) for k in stem])
    cos = cosine_gaps(prog["grad"], ref["grad"], moved)
    return {"loss": loss, "grad": grad, "grad_leaf": grad_leaf,
            "change": change, "change_leaf": change_leaf,
            "grad_cos_median": float(np.median(list(cos.values()))),
            "stats": stats, "stats_leaf": stats_leaf,
            "stem_stats": float((got - want).norm() / want.norm()),
            "left_out": sorted(set(gn) - moved)}


def diff_gaps(prog: dict, ref: dict) -> dict:
    """Each leaf's norm(prog - ref) over the larger of the reference
    leaf's norm and the median leaf's."""
    rn = _leaf_norms(ref)
    med = float(np.median(list(rn.values())))
    return {k: float((prog[k].double() - ref[k].double()).norm())
            / max(rn[k], med, 1e-30) for k in ref}


def cosine_gaps(prog: dict, ref: dict, keep) -> dict:
    """1 - cosine between the program's and the reference's tensors, for
    each leaf of ``keep``."""
    out = {}
    for k in keep:
        a, b = prog[k].double().reshape(-1), ref[k].double().reshape(-1)
        den = float(a.norm() * b.norm())
        out[k] = 1.0 - float(a @ b) / den if den > 0 else 1.0
    return out


def _on_host(readings: dict) -> dict:
    """The loss list and every tensor dict of a step's readings, on the
    host."""
    return {k: v if k == "loss" else {n: t.detach().cpu()
                                      for n, t in v.items()}
            for k, v in readings.items()}


def _rank(job: dict) -> dict:
    """One rank's run (the whole run on one card); -> its readings."""
    cfg, traffic, seed = job["cfg"], job["traffic"], job["seed"]
    fault, control = job.get("fault"), job.get("control")
    dev_type = job["device"]
    ranked = dist.is_available() and dist.is_initialized()
    rank, world = (dist.get_rank(), dist.get_world_size()) if ranked \
        else (0, 1)
    if dev_type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    else:
        dev = torch.device("cpu")
    cuda = dev.type == "cuda"
    flags = dist.new_group(backend="gloo") if world > 1 else None
    per, steps_check = traffic["batch_per_chip"], traffic["check_steps"]
    batch = per * world
    side, nc = cfg["image_size"], cfg["num_classes"]

    phases = {"imports": time.time() - job["started_wall"]}
    t = time.perf_counter()
    cli, args = _train_args(cfg, batch, str(dev))
    trainer, _, _ = cli.build_training(args)
    p0 = weights.make(cfg, seed, dev)
    missing, unexpected = trainer.model.load_state_dict(p0, strict=False)
    if unexpected or any(not k.endswith("num_batches_tracked")
                         for k in missing):
        raise RuntimeError(f"weights do not fit the program's model: "
                           f"missing {missing}, unexpected {unexpected}")
    state = trainer.init_state()
    step = trainer.train_step_fn()
    names = {p: k for k, p in trainer.model.named_parameters()}
    phases["trainer and weights"] = time.perf_counter() - t
    t = time.perf_counter()

    training = importlib.import_module(f"{PROGRAM}.training.data")
    pipeline = importlib.import_module(f"{PROGRAM}.training.input_pipeline")
    images, labels = data.make_rows(seed + 1, traffic["rows"], side, nc, dev,
                                    variety=traffic.get("row_variety"))
    ds = training.numpy_folder_dataset(images[..., None], labels, batch,
                                       seed=seed)
    recorded = []
    phases["rows"] = time.perf_counter() - t

    def recording(it):
        for b in it:
            if len(recorded) < steps_check:
                recorded.append(b)
            yield b

    feed = {"epoch": 0, "it": None}

    def start_epoch():
        src = ds.epoch(feed["epoch"])
        if feed["epoch"] == 0:
            src = recording(src)
        feed["it"] = pipeline.prefetch_to_device(src, dev,
                                                 transform=trainer._prepare)

    def next_batch():
        while True:
            try:
                return next(feed["it"])
            except StopIteration:
                feed["epoch"] += 1
                start_epoch()

    fused_bn = importlib.import_module(f"{PROGRAM}.ops.fused_bn")
    reduce_stats = fused_bn._global
    if fault == "unreduced_stats":
        # K6's sums left on their rank: each rank's BatchNorm statistics
        # from its own rows (gradients still summed)
        fused_bn._global = lambda sums, m, group: (sums, m)
    if fault == "no_exchange":
        packed = importlib.import_module(f"{PROGRAM}.training.packed_unet")
        sharding = importlib.import_module(f"{PROGRAM}.parallel.sharding")
        local = packed.make_packed_train_step(trainer.loss_fn,
                                              trainer.class_weights)

        def run_step(st, x, y):
            return local(st, *sharding.shard_batch(trainer.mesh, (x, y)))
    elif fault == "half_batch":
        def run_step(st, x, y):
            return step(st, x[: x.shape[0] // 2], y[: y.shape[0] // 2])
    elif fault == "unchanged":
        def run_step(st, x, y):
            keep = copy.deepcopy(st.model.state_dict())
            opt = copy.deepcopy(st.optimizer.state_dict())
            loss = step(st, x, y)
            st.model.load_state_dict(keep)
            st.optimizer.load_state_dict(opt)
            return loss
    else:
        run_step = step

    t = time.perf_counter()
    start_epoch()
    prog = {"loss": [], "grad": None}
    for k in range(steps_check):
        x, y = next_batch()
        prog["loss"].append(float(run_step(state, x, y)))
        if k == 0:
            # the first step's batch statistics, from the running ones
            # (0.9 * old + 0.1 * batch, as the configuration's BatchNorm)
            prog["stats"] = {
                k2: ((b.detach().cpu() - 0.9 * p0[k2].cpu()) / 0.1)
                for k2, b in trainer.model.named_buffers()
                if "running_" in k2}
            prog["grad"] = {
                names[p]: (s["exp_avg"] / (1 - B1)).detach().cpu().clone()
                if "exp_avg" in s else torch.zeros_like(p).cpu()
                for p, s in ((p, state.optimizer.state.get(p, {}))
                             for p in names)}
    prog["params"] = {names[p]: p.detach().cpu().clone() for p in names}
    phases["checked steps"] = time.perf_counter() - t

    def done(flag: bool) -> bool:
        if flags is None:
            return flag
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=flags)
        return bool(t.item())

    spans = Spans()
    trace = job["trace"]
    setup_peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        setup_peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    if world > 1:
        dist.barrier()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        prof.start()
    t_start = time.perf_counter()
    setup_s = time.time() - job["started_wall"]
    steps = 0
    trace_s = traced_steps = None
    while True:
        with spans("input wait", trace):
            x, y = next_batch()
        with spans("step", trace):
            loss = run_step(state, x, y)
        with spans("loss to host", trace):
            float(loss)
        steps += 1
        t1 = time.perf_counter()
        if prof is not None and trace_s is None and \
                t1 - t_start >= traffic["trace_seconds"]:
            prof.stop()
            trace_s, traced_steps = t1 - t_start, steps
        if done(t1 - t_start >= job["seconds"]):
            break
    window_s = t1 - t_start
    if prof is not None and trace_s is None:
        prof.stop()
        trace_s, traced_steps = window_s, steps
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    process_peak = max(setup_peak, peak)
    summary = summarize(prof, trace_s) if prof is not None else None
    fused_bn._global = reduce_stats

    # free the program's state; the producer thread ends with its epoch
    for _ in feed["it"]:
        pass
    del state, step, run_step, trainer, feed, x, y, loss
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # the reference on this rank's block of each checked batch
    t_ref = time.perf_counter()
    lo, hi = rank * per, (rank + 1) * per
    blocks = [(b[0][lo:hi].to(dev), b[1][lo:hi].to(dev)) for b in recorded]
    model = harness.reference(cfg)
    p_ref = weights.make(cfg, seed, dev)
    lr = cfg["train"]["learning_rate"]
    ref = model.train_steps(p_ref, blocks, lr)
    if control == "fp8":
        prog = model.train_steps(p_ref, blocks, lr, cast=fp8_cast)
    stem = first_bn_stats(p_ref[model.STEM[0]], recorded[0][0],
                          getattr(torch, cfg["train"]["compute_dtype"]),
                          model.STEM[1])
    readings = compare(_on_host(prog), _on_host(ref),
                       {k: p_ref[k].cpu() for k in ref["params"]},
                       {k: v.cpu() for k, v in stem.items()})
    reference_s = time.perf_counter() - t_ref
    if world > 1:
        # the ranks' parameters after the checked steps, against rank 0's
        flat = torch.cat([prog["params"][k].reshape(-1)
                          for k in sorted(prog["params"])]).to(dev)
        first = flat.clone()
        dist.broadcast(first, 0)
        gap = (flat - first).abs().max().reshape(1)
        dist.all_reduce(gap, op=dist.ReduceOp.MAX)
        readings["ranks"] = float(gap.item())
    return {
        "rank": rank, "world": world, "window_s": window_s, "steps": steps,
        "bscans": steps * batch, "setup_s": setup_s, "peak": peak,
        "process_peak": process_peak, "spans": spans.total,
        "trace": summary, "trace_s": trace_s, "traced_steps": traced_steps,
        "readings": readings, "reference_s": reference_s,
        "setup_phases": phases,
        # JAX modules this rank holds once its window has closed
        "modules": harness.forbidden_modules(),
    }


def run(cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
        device="cuda", limits: dict | None = None, fault: str | None = None,
        control: str | None = None, started: float | None = None) -> dict:
    """One run over ``traffic["chips"]`` ranks; -> the driver's result
    (see ``run.py``). ``fault`` (one of ``FAULTS``) and ``control``
    ("fp8": the reference at float8 put in the program's place) break the
    check on purpose."""
    if fault not in (None, *FAULTS) or control not in (None, "fp8"):
        raise ValueError(f"fault {fault!r}, control {control!r}")
    results = run_jobs(cfg, traffic, [dict(seed=seed, seconds=seconds,
                                           trace=trace, fault=fault,
                                           control=control)],
                       device, started)[0]
    return result(cfg, traffic, results, limits)


def run_jobs(cfg: dict, traffic: dict, jobs: list[dict], device="cuda",
             started: float | None = None) -> list[list[dict]]:
    """Each job ({"seed", "seconds", "trace", "fault", "control"}) in turn,
    on every rank; -> for each job the ranks' readings."""
    started_wall = time.time() - (time.perf_counter() - started) \
        if started is not None else time.time()
    full = [dict(j, cfg=cfg, traffic=traffic, device=device,
                 started_wall=started_wall) for j in jobs]
    chips = traffic["chips"]
    if chips == 1:
        return [[_rank(j)] for j in full]
    launch = importlib.import_module(f"{PROGRAM}.parallel.launch")
    backend = "nccl" if device == "cuda" else "gloo"
    per_rank = launch.run_ranks(_jobs_entry, chips, full, backend=backend)
    return [[per_rank[r][i] for r in range(chips)] for i in range(len(jobs))]


def _jobs_entry(jobs: list[dict]) -> list[dict]:
    return [_rank(j) for j in jobs]


def result(cfg: dict, traffic: dict, ranks: list[dict],
           limits: dict | None) -> dict:
    """The driver's result from the ranks' readings (rank 0's check)."""
    r0 = ranks[0]
    lim = limits or {}
    readings = r0["readings"]
    checks = {name: {"value": readings[key], "limit": lim.get(name, 0.0)}
              for name, key in CHECKS.items()}
    if "ranks" in readings:
        checks["rank_param_gap"] = {"value": readings["ranks"],
                                    "limit": lim.get("rank_param_gap", 0.0)}
    bscans = r0["bscans"]
    window = r0["window_s"]
    peak = max(r["peak"] for r in ranks)
    summaries = [r["trace"] for r in ranks]
    return {
        "end_to_end": {
            # every rank's steps are of the global batch: count it once
            "train_bscans_per_s": bscans / window,
            "train_peak_gib": peak / 2 ** 30,
            "setup_s": r0["setup_s"],
        },
        "ctx": {
            "cfg": cfg, "window_s": window, "bscans": bscans,
            "steps": r0["steps"], "spans": r0["spans"],
            "trace": r0["trace"], "traced_steps": r0["traced_steps"],
            "chips": len(ranks), "readings": readings,
            "reference_s": r0["reference_s"],
            "setup_phases": r0["setup_phases"],
        },
        "checks": checks,
        "attempted": r0["steps"],
        "failed": 0,
        "memory_peak_bytes": max(r["process_peak"] for r in ranks),
        "busy": [s["busy_s"] for s in summaries] if summaries[0] else None,
        "trace": r0["trace"],
        "rank_modules": sorted({m for r in ranks for m in r["modules"]}),
    }
