"""K8's cooperative body (``csrc/dice_ce.cu:dice_ce_stats_kernel``) on the
CPU: ``stats_plan`` (16-byte tile starts for both logit dtypes and label
widths, the shared memory, the grid no larger than the tiles or the
co-resident blocks), the tail predicate (every pixel added once), and a
numpy emulation of the kernel's fixed order of additions (a thread's fp32
running sums over its two pixels of each of its tiles, the warp's shuffle
tree, the warps in order, then each output's partials in fp64 over a
block's 256 threads, the warps' shuffle trees and the warps in order),
held within 1e-5 relative of the float64 plain version and of JAX's
``pallas_loss._run_fwd`` in interpret mode, and independent of the order
in which blocks finish. Imports JAX only inside the test that compares
with it.
"""

import re

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    _build,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    dice_ce as k89,
)

F32 = np.float32
THREADS = 256  # csrc/dice_ce.cu: a block's threads
SMEM_MAX = 232448  # an H100 block's shared memory (227 KB)
STATIC_SMEM = 4 * 32 + 4 * 8 * (3 * 32 + 2)  # cws and the warps' sums
DTYPES = {"bf16": (torch.bfloat16, 2), "fp32": (torch.float32, 4)}
LABELS = {"int32": (torch.int32, 4), "int64": (torch.int64, 8)}


@pytest.mark.parametrize("C", [1, 5, 10, 32])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("labels", sorted(LABELS))
def test_stats_plan(C, dtype, labels):
    """Tiles of a multiple of 8 pixels; every tile's logits and labels
    start on 16 bytes and hold whole 16-byte units; the ring fits a block;
    the grid no larger than the tiles or the co-resident blocks."""
    xb, lb = DTYPES[dtype][1], LABELS[labels][1]
    for P in (1, 7, 256, 257, 8 * 512 * 512):
        for co_resident in (1, 528, 10 ** 6):
            plan = k89.stats_plan(P, C, xb, lb, co_resident=co_resident)
            assert plan.tile % 8 == 0
            assert plan.tile * C * xb % 16 == 0 and plan.tile * lb % 16 == 0
            assert plan.smem == k89.STATS_STAGES * plan.tile * (C * xb + lb)
            assert plan.smem + STATIC_SMEM <= SMEM_MAX
            assert plan.tiles == -(-P // plan.tile)
            assert 1 <= plan.grid <= min(plan.tiles, co_resident)
            assert f"grid {plan.grid} of {plan.tiles}" in plan.text()


@pytest.mark.parametrize("P", [1, 7, 255, 256, 300, 1025])
@pytest.mark.parametrize("grid", [1, 3, 64])
def test_tail_predicate_counts_every_pixel_once(P, grid):
    """Block g takes tiles g, g + grid, ...; thread t of a tile adds
    pixels i = t, t + 256, ... (i < tile_size), each where i < P - tile *
    tile_size."""
    plan = k89.stats_plan(P, 10, 2, 8, co_resident=grid)
    seen = np.zeros(P, int)
    for g in range(plan.grid):
        for tile in range(g, plan.tiles, plan.grid):
            for t in range(THREADS):
                for i in range(t, plan.tile, THREADS):
                    if i < P - tile * plan.tile:
                        seen[tile * plan.tile + i] += 1
    assert (seen == 1).all()


def _warp_tree(v):
    """v (..., 32) float32 -> lane 0 of ``warp_sum`` (shuffle down 16, 8,
    4, 2, 1)."""
    v = v.copy()
    for o in (16, 8, 4, 2, 1):
        v[..., :o] = v[..., :o] + v[..., o:2 * o]
    return v[..., 0]


def block_partial(x, lab, cw, plan, g):
    """Block g's (3C + 2,) fp32 partial: its threads' running sums over
    their pixels (t, t + 256, ... of each of its tiles, in order), each
    warp's tree, the warps in order."""
    C, T = plan.C, THREADS
    inter = np.zeros((T, C), F32)
    sp = np.zeros((T, C), F32)
    cnt = np.zeros((T, C), F32)
    sll = np.zeros(T, F32)
    sw = np.zeros(T, F32)
    classes = np.arange(C)
    steps = [(tile, k) for tile in range(g, plan.tiles, plan.grid)
             for k in range(plan.tile // T)]
    for tile, k in steps:
        i = k * T + np.arange(T)  # thread t's pixel of the tile
        live = i < plan.P - tile * plan.tile
        idx = np.minimum(tile * plan.tile + i, plan.P - 1)
        xi, li = x[idx], lab[idx]
        m = xi.max(axis=1)
        e = np.exp(xi - m[:, None]).astype(F32)
        s = np.zeros(T, F32)
        for c in range(C):  # softmax_pixel's sum, in class order
            s = s + e[:, c]
        inv = F32(1) / s
        logs = np.log(s).astype(F32)
        pc = e * inv[:, None]
        t = li[:, None] == classes
        w = np.where(t, cw, F32(0)).sum(axis=1).astype(F32)  # one or none
        x_l = np.where(t, xi, F32(0)).sum(axis=1).astype(F32)
        zero = F32(0)
        sp = sp + np.where(live[:, None], pc, zero)
        inter = inter + np.where(live[:, None] & t, pc, zero)
        cnt = cnt + np.where(live[:, None] & t, F32(1), zero)
        sll = sll + np.where(live, (x_l - m - logs) * w, zero)
        sw = sw + np.where(live, w, zero)
    sums = np.concatenate([inter, sp, cnt, sll[:, None], sw[:, None]],
                          axis=1)  # (T, 3C + 2)
    per_warp = _warp_tree(sums.T.reshape(3 * C + 2, T // 32, 32))
    v = np.zeros(3 * C + 2, F32)
    for j in range(T // 32):  # the warps in order
        v = v + per_warp[:, j]
    return v


def emulate(x, lab, cw, plan, order=None):
    """K8's (3C + 2,) float32 statistics of x (P, C) float32 (the logits'
    values), labels (P,), cw (C,) on ``plan``; the blocks' partials are
    computed in ``order`` (default 0, 1, ...), as they may finish."""
    x = np.asarray(x, F32).reshape(plan.P, plan.C)
    lab = np.asarray(lab).reshape(plan.P)
    cw = np.asarray(cw, F32)
    G, K = plan.grid, 3 * plan.C + 2
    part = np.zeros((G, K), F32)
    for g in (range(G) if order is None else order):
        part[g] = block_partial(x, lab, cw, plan, g)
    threads = np.zeros((K, THREADS), np.float64)
    for q in range(G):  # thread q % 256 adds partial q, in order
        threads[:, q % THREADS] += np.float64(part[q])
    per_warp = _warp_tree(threads.reshape(K, THREADS // 32, 32))
    out = np.zeros(K, np.float64)
    for j in range(THREADS // 32):  # the warps in order
        out = out + per_warp[:, j]
    return out.astype(F32)


def _case(shape, C, dtype, seed):
    """bf16- or fp32-valued N(0, 3) logits (as float32 numpy), labels in
    [0, C] (C: outside the classes), class weights in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.standard_normal(shape + (C,)) * 3,
                     dtype=DTYPES[dtype][0]).float().numpy()
    lab = rng.integers(0, C + 1, shape)
    cw = rng.uniform(0.5, 2.0, C).astype(F32)
    return x, lab, cw


@pytest.mark.parametrize("shape,C,dtype,co_resident", [
    ((2, 64, 64), 10, "bf16", 5),    # several tiles a block
    ((1, 37, 29), 10, "bf16", 528),  # a ragged last tile, grid = tiles
    ((3, 33, 17), 5, "fp32", 2),
    ((1, 40, 40), 32, "fp32", 3),
    ((1, 1, 1), 1, "bf16", 1),
    ((8, 64, 64), 10, "bf16", 40),   # 40 blocks
    ((8, 256, 256), 10, "bf16", 300),  # 300 blocks: two partials a thread
])
def test_emulation_matches_float64(shape, C, dtype, co_resident):
    """Within 1e-5 relative of the float64 sums (labels outside the
    classes count for nothing; no sum cancels but the log-likelihood's,
    which all pixels add with one sign)."""
    x, lab, cw = _case(shape, C, dtype, seed=C)
    P = int(np.prod(shape))
    plan = k89.stats_plan(P, C, DTYPES[dtype][1], 8,
                          co_resident=co_resident)
    got = emulate(x, lab, cw, plan)
    want = k89.dice_ce_stats_reference(
        torch.from_numpy(x).double(), torch.from_numpy(lab),
        torch.from_numpy(cw)).double().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("co_resident", [3, 40])
def test_emulation_does_not_depend_on_the_order_blocks_finish(co_resident):
    """Each block writes its own row of partials, so blocks finishing in a
    shuffled or reversed order give the same bits."""
    x, lab, cw = _case((4, 48, 40), 10, "bf16", seed=7)
    plan = k89.stats_plan(x.shape[0] * 48 * 40, 10, 2, 8,
                          co_resident=co_resident)
    first = emulate(x, lab, cw, plan)
    rng = np.random.default_rng(0)
    for order in (rng.permutation(plan.grid), range(plan.grid)[::-1]):
        assert np.array_equal(emulate(x, lab, cw, plan, order), first)


@pytest.mark.parametrize("uniform", [True, False])
def test_emulation_matches_jax_run_fwd(uniform):
    """Against the TPU kernel (``pallas_loss._run_fwd``, interpret mode)
    on NCHW bf16 logits (1, 10, 8, 128) with int32 labels."""
    import jax.numpy as jnp

    from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
        pallas_loss,
    )

    C = 10
    x, lab, cw = _case((1, 8, 128), C, "bf16", seed=11)
    if uniform:
        cw = np.ones(C, F32)
    want = pallas_loss._run_fwd(
        jnp.asarray(x.transpose(0, 3, 1, 2), jnp.bfloat16),
        jnp.asarray(lab, jnp.int32),
        jnp.broadcast_to(jnp.asarray(cw)[:, None], (C, 128)))
    plan = k89.stats_plan(lab.size, C, 2, 4, co_resident=3)
    np.testing.assert_allclose(emulate(x, lab, cw, plan), np.asarray(want),
                               rtol=1e-5, atol=0)


def test_source_constants_match_the_plan():
    """The tile, ring and thread counts of the source are the plan's."""
    src = (_build.CSRC / "dice_ce.cu").read_text()
    assert re.search(rf"constexpr int STATS_TP = {k89.STATS_TILE // THREADS} "
                     r"\* THREADS;", src)
    assert re.search(rf"constexpr int STATS_STAGES = {k89.STATS_STAGES};",
                     src)
    assert re.search(rf"constexpr int THREADS = {THREADS};", src)
    assert "cudaLaunchCooperativeKernel" in src
    assert "this_grid().sync()" in src
    assert "atomicAdd" not in src
