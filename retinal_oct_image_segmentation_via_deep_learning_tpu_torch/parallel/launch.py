"""Run a function on n local ranks: one spawned process each, joined in
one process group over ``tcp://localhost`` (``run_ranks``). The command
line's ``infer --spatial N`` and ``dryrun_multichip`` start their ranks
this way."""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import default_backend


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, n, port, backend, threads, args, results):
    try:
        torch.set_num_threads(threads)
        if backend == "nccl":
            torch.cuda.set_device(rank)
        os.environ.update(RANK=str(rank), WORLD_SIZE=str(n),
                          LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(n))
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=n, rank=rank,
                                timeout=datetime.timedelta(minutes=10))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor sent through the queue's shared memory dies
        # with the process that made it
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # the parent raises it, with the traceback
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, n: int, *args, backend: str | None = None,
              timeout: float = 1800.0) -> list:
    """``fn(*args)`` on ranks 0..n-1 of a new process group (``backend``:
    by default NCCL where the host has n cards, else gloo; under NCCL rank
    r runs on card r). ``fn`` and its arguments must be picklable (a
    module-level function). The ranks share the caller's intra-op
    threads. -> the ranks' return values in rank order; raises with the
    first failing rank's traceback (or exit code), and stops every rank
    it started."""
    backend = backend or default_backend(n)
    threads = max(1, torch.get_num_threads() // n)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, n, port, backend, threads, args,
                               results))
             for r in range(n)]
    for p in procs:
        p.start()
    got: dict[int, object] = {}
    try:
        deadline = time.monotonic() + timeout
        while len(got) < n:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                # a rank that died without a word (a crash in a library);
                # one that exited cleanly has its result in the pipe
                for r, p in enumerate(procs):
                    if r not in got and p.exitcode not in (None, 0):
                        raise RuntimeError(
                            f"rank {r} of {n} exited with code {p.exitcode} "
                            "and no result") from None
                if time.monotonic() > deadline:
                    raise RuntimeError(f"run_ranks: {n - len(got)} rank(s) "
                                       f"gave no result in {timeout} s"
                                       ) from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed:\n{out}")
            got[rank] = pickle.loads(out)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
    return [got[r] for r in range(n)]
