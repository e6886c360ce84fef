"""The port's training BatchNorm (``ops/fused_bn``: ``bn_train`` on K6, and
``models/blocks.BatchNorm``) against the JAX package's ``bn_train`` and
flax's running-stat update.

On the CPU ``pair_sums`` takes its plain version (float64 sums rounded to
float32); it is held against JAX's Pallas ``_pallas_pair_sums`` in
interpret mode.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    fused_bn as jbn,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.blocks import (
    BatchNorm,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    fused_bn as tbn,
)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _data(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.5, 2, shape).astype(np.float32)
    g = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.normal(0, 1, shape[-1]).astype(np.float32)
    r = rng.normal(0, 1, shape).astype(np.float32)
    x = torch.tensor(x, dtype=dtype).float().numpy()  # representable
    return x, g, b, r


def _f32(t):
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.detach().float().numpy()


@pytest.mark.parametrize("shape", [(3, 8, 10, 6), (2, 4, 4, 32), (6, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_matches_jax(shape, dtype):
    """mean and var at atol 1e-5, y at 1e-5 and the VJP at 1e-4. In bf16, y
    and dx are rounded once from float32 values whose sums were taken in
    another order (float64 here, float32 in XLA), so they may differ by one
    bf16 rounding step (2^-8 relative) on top."""
    x, g, b, r = _data(sum(shape), shape, dtype)
    xj = jnp.asarray(x, JDT[dtype])
    (yj, mj, vj), vjp = jax.vjp(jbn.bn_train, xj, jnp.asarray(g),
                                jnp.asarray(b))
    gj = vjp((jnp.asarray(r, JDT[dtype]), jnp.zeros_like(mj),
              jnp.zeros_like(vj)))

    xt = torch.tensor(x, dtype=dtype).requires_grad_()
    gt = torch.tensor(g).requires_grad_()
    bt = torch.tensor(b).requires_grad_()
    y, mean, var = tbn.bn_train(xt, gt, bt)
    assert y.dtype == dtype and mean.dtype == var.dtype == torch.float32
    assert not mean.requires_grad and not var.requires_grad
    np.testing.assert_allclose(_f32(mean), _f32(mj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_f32(var), _f32(vj), rtol=0, atol=1e-5)
    y_atol = 1e-5 if dtype == torch.float32 else \
        float(np.abs(_f32(yj)).max()) * 2 ** -8
    np.testing.assert_allclose(_f32(y), _f32(yj), rtol=0, atol=y_atol)

    grads = torch.autograd.grad(y, (xt, gt, bt),
                                torch.tensor(r, dtype=dtype))
    for got, want in zip(grads, gj):
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4,
                                   atol=1e-4 if dtype == torch.float32
                                   else 1e-4 + 2 ** -8 * np.abs(
                                       _f32(want)).max())


@pytest.mark.parametrize("two", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pair_sums_plain_matches_pallas(two, dtype):
    """K6's plain version vs the Pallas kernel in interpret mode, both
    modes, within rtol 1e-6."""
    rng = np.random.default_rng(11)
    a = torch.tensor(rng.normal(1, 1, (2, 8, 16, 32)), dtype=dtype)
    b = torch.tensor(rng.normal(1, 1, a.shape), dtype=dtype) if two else None
    want = jbn._pallas_pair_sums(
        jnp.asarray(a.float().numpy(), JDT[dtype]),
        None if b is None else jnp.asarray(b.float().numpy(), JDT[dtype]),
        interpret=True,
    )
    got = tbn.pair_sums(a, b)
    assert got.shape == (2, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


def test_pair_sums_groups_cover_the_rows():
    """``pair_sums_plan``: the blocks' row ranges cover [0, M) once, in
    whole block steps; the grid stays within the co-resident bound passed
    in (the launch is cooperative); a lane owns 8 channels exactly where C
    % 8 == 0 (and the inputs are aligned); the lanes and rows of a block
    fit its threads."""
    cases = [(1, 5), (100, 32), (2 * 512 * 512, 32), (2048, 512), (0, 8),
             (6, 5), (132, 130), (8 * 512 * 512, 32), (8 * 32 * 32, 512),
             (4 * 512 * 512, 1), (4, 32), (7, 8192), (1000, 300)]
    for m, c in cases:
        for dtype in (torch.bfloat16, torch.float32):
            for co_resident in (1, 5, 396, 1056):
                plan = tbn.pair_sums_plan(m, c, dtype,
                                          co_resident=co_resident)
                assert 1 <= plan.grid <= co_resident
                assert plan.rows_block % plan.rows_step == 0
                rows = [r for g in range(plan.grid) for r in plan.rows(g)]
                assert rows == list(range(m))
                assert all(len(plan.rows(g)) for g in range(plan.grid)) \
                    or m == 0
                assert plan.vec == (8 if c % 8 == 0 else 1)
                assert plan.lanes == min(c // plan.vec, tbn.THREADS)
                assert plan.lanes * plan.rows_step <= tbn.THREADS
        assert tbn.pair_sums_plan(m, c, torch.float32, co_resident=9,
                                  aligned=False).vec == 1


def test_k6_binding_matches_the_c_entry_points():
    """The ctypes argument lists of K6's two entry points have one entry
    per parameter of the C functions: pointers where they take pointers,
    64-bit integers where they take ``long long``."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    src = (_build.CSRC / "bn_pair_sums.cu").read_text()
    for name in ("octseg_bn_pair_sums", "octseg_bn_pair_sums_resident"):
        params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                           src).group(1).split(",")
        argtypes = _build.SIGNATURES[name]
        assert len(params) == len(argtypes)
        for p, t in zip(params, argtypes):
            assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
            assert ("long long" in p) == (t is ctypes.c_longlong), (p, t)


def test_batchnorm_module_train_and_eval():
    """Train mode: ``bn_train`` on the channels-last view and flax's
    running-stat update (0.9 old + 0.1 batch, biased variance), once per
    call; eval mode: running statistics in float32, the input's dtype out;
    the state-dict names of ``nn.BatchNorm2d``."""
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(1, 2, (2, 4, 6, 6)), dtype=torch.bfloat16)
    bn = BatchNorm(4)
    assert set(bn.state_dict()) == {"weight", "bias", "running_mean",
                                    "running_var", "num_batches_tracked"}
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    bn.train()
    y = bn(x)
    xf = x.float().permute(0, 2, 3, 1).reshape(-1, 4).double()
    mean, var = xf.mean(0), xf.var(0, unbiased=False)
    np.testing.assert_allclose(bn.running_mean.numpy(), 0.1 * mean.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               0.9 + 0.1 * var.numpy(), rtol=1e-5)
    want, _, _ = tbn.bn_train(x.permute(0, 2, 3, 1), bn.weight, bn.bias)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape
    assert torch.equal(y, want.permute(0, 3, 1, 2))

    bn.eval()
    with torch.no_grad():
        ye = bn(x)
        inv = torch.rsqrt(bn.running_var + 1e-5)
        ref = ((x.float() - bn.running_mean[:, None, None])
               * inv[:, None, None] * bn.weight[:, None, None]
               + bn.bias[:, None, None])
    assert ye.dtype == torch.bfloat16
    # one bf16 rounding of the float32 result
    np.testing.assert_allclose(ye.float().numpy(), ref.numpy(), rtol=2 ** -8,
                               atol=1e-6)
