"""K6's order of additions (``csrc/bn_pair_sums.cu``), emulated in numpy
float32 on the CPU: each lane's Kahan pairs over its rows (products by a
float32 multiply, never fused into the add), the block's fixed tree of
two-sums over its lanes, the cross-block lanes and the warp's shuffle
tree, on the plan ``pair_sums_plan`` gives. The emulation is held within
rtol 1e-6 of the float64 plain version and of JAX's ``_pallas_pair_sums``
in interpret mode, and does not depend on the order in which blocks
finish. On the card the kernel is held bit for bit to ``emulate``
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 6), so this module
imports JAX only inside the test that compares with it.
"""

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    fused_bn as k6,
)

F32 = np.float32
# blocks an H100 holds of a K6 instance at three blocks an SM, and a small
# bound that forces long blocks
CO_RESIDENT = (3 * 132, 5)
SHAPES = [(2, 16, 16, 32), (3, 8, 8, 512), (6, 5), (4, 33, 130),
          (2, 16, 16, 1), (4, 32),
          # 128 blocks: the cross-block lanes take four partials each
          (8, 64, 64, 8)]


def _kahan(s, e, v, m):
    """(s, e) + v where ``m``, as ``kahan_add``."""
    y = v + e
    t = s + y
    return np.where(m, t, s), np.where(m, y - (t - s), e)


def _pair_add(s, e, s2, e2):
    """(s, e) + (s2, e2), as ``pair_add``."""
    t = s + s2
    z = t - s
    f = (e + e2) + ((s - (t - z)) + (s2 - z))
    u = t + f
    return u, f - (u - t)


def block_partial(a, b, plan, g):
    """Block ``g``'s (s, e) partial: (2, 2C) float32, the s then the e
    plane, output i = k * C + c."""
    R, C = plan.rows_step, plan.C
    rows = plan.rows(g)
    acc = np.zeros((4, R, C), F32)
    for r in range(rows.start, rows.stop, R):
        idx = r + np.arange(R)
        m = (idx < rows.stop)[:, None]
        idx = np.minimum(idx, plan.M - 1)
        va, vb = a[idx], b[idx]
        acc[0], acc[1] = _kahan(acc[0], acc[1], va, m)
        acc[2], acc[3] = _kahan(acc[2], acc[3], va * vb, m)
    n = R
    while n > 1:  # item i += item i + h for i < n - h
        h = (n + 1) // 2
        lo, hi = acc[:, :n - h], acc[:, h:n]
        s0, e0 = _pair_add(lo[0], lo[1], hi[0], hi[1])
        s1, e1 = _pair_add(lo[2], lo[3], hi[2], hi[3])
        acc[0, :n - h], acc[1, :n - h] = s0, e0
        acc[2, :n - h], acc[3, :n - h] = s1, e1
        n = h
    return np.stack([np.concatenate([acc[0, 0], acc[2, 0]]),
                     np.concatenate([acc[1, 0], acc[3, 0]])])


def emulate(a, b, plan, order=None):
    """K6's (2, C) result for ``a`` (and ``b``) on ``plan``, in numpy
    float32 in the kernel's order of additions; the blocks' partials are
    computed in ``order`` (default: 0, 1, ...), as they may finish."""
    a = np.asarray(a, F32).reshape(plan.M, plan.C)
    b = a if b is None else np.asarray(b, F32).reshape(plan.M, plan.C)
    G = plan.grid
    part = np.zeros((2, 2 * plan.C, G), F32)
    for g in (range(G) if order is None else order):
        part[:, :, g] = block_partial(a, b, plan, g)
    s = np.zeros((2 * plan.C, 32), F32)
    e = np.zeros_like(s)
    for q0 in range(0, G, 32):  # lane l takes g = l, l + 32, ...
        q = q0 + np.arange(32)
        m = q < G
        q = np.minimum(q, G - 1)
        ns, ne = _pair_add(s, e, part[0][:, q], part[1][:, q])
        s, e = np.where(m, ns, s), np.where(m, ne, e)
    for off in (16, 8, 4, 2, 1):  # __shfl_down_sync
        s[:, :off], e[:, :off] = _pair_add(s[:, :off], e[:, :off],
                                           s[:, off:2 * off],
                                           e[:, off:2 * off])
    return s[:, 0].reshape(2, plan.C)


def _inputs(shape, two, bf16, seed=3):
    """N(1, 1) inputs (positive means: no sum cancels), bf16-valued or
    float32, as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2 if two else 1):
        x = torch.tensor(rng.normal(1, 1, shape), dtype=torch.float32)
        if bf16:
            x = x.bfloat16().float()
        out.append(x.numpy())
    return out[0], (out[1] if two else None)


def _plan(shape, bf16, co_resident=CO_RESIDENT[0]):
    return k6.pair_sums_plan(int(np.prod(shape[:-1])), shape[-1],
                             torch.bfloat16 if bf16 else torch.float32,
                             co_resident=co_resident)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("two", [False, True])
def test_emulation_matches_float64_and_pallas(shape, bf16, two):
    import jax.numpy as jnp

    from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
        fused_bn as jbn,
    )

    a, b = _inputs(shape, two, bf16)
    plan = _plan(shape, bf16)
    assert plan.vec == (8 if shape[-1] % 8 == 0 else 1)
    got = emulate(a, b, plan)
    assert got.dtype == F32 and got.shape == (2, shape[-1])
    want = k6.pair_sums_reference(torch.from_numpy(a),
                                  None if b is None else torch.from_numpy(b))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-6, atol=0)
    four = (1,) * (4 - len(shape)) + shape  # the Pallas kernel's NHWC
    jdt = jnp.bfloat16 if bf16 else jnp.float32
    pallas = jbn._pallas_pair_sums(
        jnp.asarray(a.reshape(four), jdt),
        None if b is None else jnp.asarray(b.reshape(four), jdt),
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (4, 33, 130),
                                   (8, 64, 64, 8)])
@pytest.mark.parametrize("co_resident", CO_RESIDENT)
def test_emulation_does_not_depend_on_the_order_blocks_finish(shape,
                                                              co_resident):
    """The partials land in their own slots, so the blocks finishing in a
    shuffled or reversed order give the same bits."""
    a, b = _inputs(shape, True, True, seed=4)
    plan = _plan(shape, True, co_resident)
    want = emulate(a, b, plan)
    rng = np.random.default_rng(5)
    for order in (rng.permutation(plan.grid), range(plan.grid)[::-1]):
        assert np.array_equal(emulate(a, b, plan, order), want)

