"""The device mesh: ranks of ``torch.distributed`` in a ("data", "space")
grid (the JAX package's ``parallel/mesh.py``).

A rank is one process and one device. ``Mesh`` holds the grid of global
ranks and this rank's process group along each axis: data parallelism
over "data", spatial (halo-exchange) sharding of oversized B-scans over
"space" (``parallel.halo``). The space axis takes consecutive ranks, as
JAX's takes consecutive devices. One process without a process group is a
1 x 1 mesh.

Backends: NCCL where each rank of a host has its own card, gloo otherwise
(CPU ranks, or several ranks on one card, which NCCL refuses);
``parallel.collectives`` stages CUDA tensors through host buffers on gloo.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
AXES = (DATA_AXIS, SPACE_AXIS)


def world() -> tuple[int, int]:
    """(this rank, the number of ranks); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A (data, space) grid of global ranks with this rank's group along
    each axis (None where the axis has one rank) and ``group_all`` over the
    whole grid. ``shape`` maps axis names to sizes, as a JAX mesh's."""

    def __init__(self, ranks: np.ndarray, groups: dict, group_all):
        self.ranks = ranks
        self.groups = groups
        self.group_all = group_all
        self.shape = dict(zip(AXES, ranks.shape))
        me = np.argwhere(ranks == world()[0])
        self.coords = tuple(int(c) for c in me[0]) if len(me) else None

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, coords={self.coords})"

    def _axis(self, axis: str) -> int:
        if axis not in AXES:
            raise ValueError(f"axis {axis!r}: one of {AXES}")
        if self.coords is None:
            raise ValueError(f"rank {world()[0]} is not in {self!r}")
        return AXES.index(axis)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's position along ``axis``."""
        return self.coords[self._axis(axis)]

    def axis_ranks(self, axis: str) -> list[int]:
        """Global ranks along ``axis`` through this rank, in axis order."""
        k = self._axis(axis)
        line = self.ranks[:, self.coords[1]] if k == 0 else \
            self.ranks[self.coords[0]]
        return [int(r) for r in line]

    def group(self, axis: str):
        self._axis(axis)
        return self.groups[axis]


def create_mesh(data: int | None = None, space: int = 1) -> Mesh:
    """A (data, space) mesh over the ranks: ``data=None`` takes every rank
    that ``space`` leaves. Every rank of the process group must call it
    (it creates the axis groups); ranks past ``data * space`` are outside
    the mesh."""
    _, n = world()
    if data is None:
        if n % space:
            raise ValueError(f"{n} ranks not divisible by space={space}")
        data = n // space
    if data < 1 or space < 1 or data * space > n:
        raise ValueError(f"Mesh {data}x{space} needs {data * space} ranks, "
                         f"have {n}")
    ranks = np.arange(data * space).reshape(data, space)
    groups = {DATA_AXIS: None, SPACE_AXIS: None}
    group_all = None
    if n > 1:
        me = world()[0]
        # new_group is collective: every rank creates every group, in order
        group_all = _new_group(ranks.ravel()) if data * space < n else \
            dist.group.WORLD
        for axis, lines in ((SPACE_AXIS, ranks), (DATA_AXIS, ranks.T)):
            if lines.shape[1] == 1:
                continue
            for line in lines:
                g = _new_group(line)
                if me in line:
                    groups[axis] = g
    return Mesh(ranks, groups, group_all)


def _new_group(ranks) -> object:
    return dist.new_group([int(r) for r in ranks])


def local_mesh(n: int | None = None) -> Mesh:
    """Data-parallel-only mesh over the first ``n`` ranks (all by
    default)."""
    return create_mesh(data=n if n is not None else world()[1], space=1)


def default_backend(ranks_per_host: int) -> str:
    """NCCL where each of the host's ranks has a card of its own, else
    gloo."""
    if torch.cuda.is_available() and \
            torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


def distributed_init(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, *,
                     backend: str | None = None) -> bool:
    """Join the process group (``init_process_group``). The arguments
    default to the usual environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_WORLD_SIZE``, as torchrun sets them);
    ``coordinator_address`` is "host:port". A single process (no
    coordinator, one process) returns False and touches nothing; a second
    call returns True. ``local_device_ids[0]`` is this rank's card, by
    default ``LOCAL_RANK`` under NCCL. The backend defaults to
    ``default_backend``."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:" \
                              f"{env.get('MASTER_PORT', '29500')}"
    if num_processes in (None, 1) and coordinator_address is None:
        return False
    if dist.is_initialized():
        return True
    if process_id is None:
        process_id = int(env.get("RANK", "0"))
    if num_processes is None or coordinator_address is None:
        raise ValueError("distributed_init: a coordinator address and a "
                         "process count are both needed "
                         f"(got {coordinator_address!r}, {num_processes!r})")
    per_host = int(env.get("LOCAL_WORLD_SIZE", num_processes))
    backend = backend or default_backend(per_host)
    if backend == "nccl":
        dev = (local_device_ids[0] if local_device_ids
               else int(env.get("LOCAL_RANK", process_id % per_host)))
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(minutes=10))
    return True


def create_hybrid_mesh(ici_data: int | None = None,
                       dcn_data: int | None = None,
                       space: int = 1) -> Mesh:
    """A (data, space) mesh over several hosts: the data axis host-major
    (``dcn_data`` hosts, by default ``WORLD_SIZE / LOCAL_WORLD_SIZE``,
    times ``ici_data`` ranks of each), so a host's ranks are adjacent on
    it, and the space axis within a host. Ranks are numbered host-major,
    as torchrun numbers them."""
    _, n = world()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    if dcn_data is None:
        dcn_data = max(n // per_host, 1)
    if ici_data is None:
        ici_data = n // (dcn_data * space)
    if dcn_data > 1 and (ici_data * space != per_host):
        raise ValueError(f"hybrid mesh: {ici_data} x {space} ranks a host, "
                         f"but {per_host} ranks run on each")
    return create_mesh(data=dcn_data * ici_data, space=space)
