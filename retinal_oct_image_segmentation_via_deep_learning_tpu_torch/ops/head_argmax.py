"""K3: the 1x1 int8 classifier head fused with the per-pixel argmax.

Replaces the TPU kernels ``ops/pallas_conv_psrp.py:head_argmax_psrp`` and
``ops/pallas_conv_packed.py:head_argmax_packed``. Per pixel: the int8 dot
of the cin channels with each class's weights, the float32 logit
``fmaf(float(acc), scale[k], bias[k])`` (no round, no clip, ``scale =
s_head_in*s_w``, ``bias = b``), and the argmax with ties going to the
lowest class. Output: (N, H, W) int8 labels; the logits never reach device
memory.

The wrapper runs the CUDA kernel (``csrc/head_argmax.cu:head_argmax_mma``:
int8 ``mma.sync`` fed by 16-byte ``cp.async`` copies, on a persistent grid;
its launch is ``head_plan``'s) for a CUDA tensor and the plain version only
for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .conv_int8 import _check, _check_cuda_int8, _check_vec, _stream

MAX_CIN = 64
MAX_CLASSES = 32
# csrc/head_argmax.cu: threads a block, pixels a tile (32 a warp), ring slots
THREADS = 256
TILE = 256
STAGES = 3


def pack_head_weights(w_q: torch.Tensor) -> torch.Tensor:
    """(nc, cin, 1, 1) int8 -> (nc, cin) int8; cin must be a multiple of 4.
    Row n is column n of the tensor-core product's B operand: the kernel
    reads its fragments from it as 4-byte words."""
    nc, cin = w_q.shape[:2]
    assert cin % 4 == 0 and w_q.dtype == torch.int8, w_q.shape
    return w_q.reshape(nc, cin).contiguous()


class HeadPlan(NamedTuple):
    """K3's launch for one call (``head_plan``). ``ks`` k-steps of 32
    channels and ``nt`` n8 tiles of classes (the kernel's instance);
    ``chunk`` bytes a copy (16 where cin % 16 == 0, else 4); tiles of
    ``tile`` pixels, ``tile * ks * 32`` bytes a slot, ``stages`` slots and
    a 32-byte staging row a warp: ``smem`` bytes; a persistent grid of
    ``grid`` blocks walks the ``tiles`` tiles g, g + grid, ..."""

    P: int
    cin: int
    nc: int
    ks: int
    nt: int
    chunk: int
    tile: int
    stages: int
    smem: int
    tiles: int
    grid: int

    def text(self) -> str:
        return (f"ks {self.ks} nt {self.nt} chunk {self.chunk} tile "
                f"{self.tile} stages {self.stages} smem {self.smem} grid "
                f"{self.grid} of {self.tiles} tiles")


def head_plan(P: int, cin: int, nc: int, *, co_resident: int) -> HeadPlan:
    """K3's plan for P pixels of cin channels (a multiple of 4, <= 64) and
    nc classes (1..32); ``co_resident``: the blocks of its instance the
    card holds at once."""
    ks, nt = -(-cin // 32), -(-nc // 8)
    smem = STAGES * TILE * ks * 32 + THREADS
    tiles = -(-P // TILE)
    return HeadPlan(P, cin, nc, ks, nt, 16 if cin % 16 == 0 else 4, TILE,
                    STAGES, smem, tiles, max(1, min(tiles, co_resident)))


@functools.lru_cache(maxsize=64)
def _co_resident(index: int, cin: int, nc: int) -> int:
    """Blocks of K3's instance for (cin, nc) the card holds at once."""
    n = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _build.lib().octseg_head_argmax_resident(cin, nc,
                                                       ctypes.addressof(n))
    _build.check(err, "head_argmax occupancy")
    return n.value


def launch_plan(x: torch.Tensor, nc: int) -> HeadPlan:
    """The plan ``head_argmax`` launches for a CUDA input ``x``."""
    cin = x.shape[-1]
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    return head_plan(x.numel() // cin, cin, nc,
                     co_resident=_co_resident(index, cin, nc))


def head_argmax_reference(x: torch.Tensor, w: torch.Tensor,
                          scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Plain version of K3 (any device)."""
    acc = x.double() @ w.double().T  # exact: |acc| << 2^53
    z = (acc.float().double() * scale.double() + bias.double()).float()
    return z.argmax(dim=-1).to(torch.int8)  # first maximum on ties


def head_argmax(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """(N, H, W, cin) int8 -> (N, H, W) int8 labels. w: ``pack_head_weights``.
    A CUDA input must be 16-byte aligned."""
    if x.device.type == "cpu":
        return head_argmax_reference(x, w, scale, bias)
    dev = x.device
    _check(dev.type == "cuda", f"head_argmax: unsupported device {dev}")
    _check_cuda_int8(x, 4, "head_argmax input", dev)
    _check(x.data_ptr() % 16 == 0, "head_argmax input: not 16-byte aligned")
    cin = x.shape[-1]
    nc = scale.shape[0]
    _check(cin % 4 == 0 and cin <= MAX_CIN,
           f"head_argmax: cin {cin} must be a multiple of 4, <= {MAX_CIN}")
    _check(1 <= nc <= MAX_CLASSES,
           f"head_argmax: {nc} classes, at most {MAX_CLASSES}")
    _check_cuda_int8(w, 2, "head_argmax weights", dev)
    _check(tuple(w.shape) == (nc, cin),
           f"head_argmax: weights {tuple(w.shape)}, expected {(nc, cin)}")
    _check_vec(scale, nc, "head_argmax scale", dev)
    _check_vec(bias, nc, "head_argmax bias", dev)
    y = torch.empty(x.shape[:3], dtype=torch.int8, device=dev)
    plan = launch_plan(x, nc)
    with torch.cuda.device(dev):
        err = _build.lib().octseg_head_argmax(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            y.data_ptr(), plan.P, cin, nc, plan.grid, _stream(x))
    _build.check(err, "head_argmax")
    head_argmax.launches += 1
    return y


head_argmax.launches = 0
