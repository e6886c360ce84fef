"""The port's training BatchNorm (``ops/fused_bn``: ``bn_train`` on K6, and
``models/blocks.BatchNorm``) against the JAX package's ``bn_train`` and
flax's running-stat update.

On the CPU ``pair_sums`` takes its plain version (float64 sums rounded to
float32); it is held against JAX's Pallas ``_pallas_pair_sums`` in
interpret mode. ``bn_train(..., relu=True)`` (K13, K14 and K6's masked
mode on the card; here their plain versions) against ``torch.relu`` of
``bn_train``, bit for bit, also under ``torch.utils.checkpoint`` and on a
two-rank gloo data-parallel group; its dispatch rule (the plain versions
for a CPU tensor only; the kernels' dtype check); the plans and the
ctypes bindings of the new kernels.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

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
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.collectives import (
    data_parallel,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.launch import (
    run_ranks,
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


# ------------------------------------------------- bn_train(..., relu=True)


def _relu_case(C, dtype, seed=0):
    """(x, gamma, beta, dy) of shape (2, 3, 4, C) whose second half of rows
    is the first half negated, with zeros among them: every channel's mean
    is exactly 0, so where beta is 0 (the even channels) y is exactly 0
    wherever x is, and the ReLU meets ties at 0."""
    rng = np.random.default_rng(seed + C)
    half = torch.tensor(rng.normal(0.3, 2, (12, C)), dtype=dtype)
    half[rng.random((12, C)) < 0.25] = 0
    x = torch.cat([half, -half]).reshape(2, 3, 4, C)
    gamma = torch.tensor(rng.uniform(0.5, 1.5, C), dtype=torch.float32)
    beta = torch.tensor(rng.normal(0, 1, C), dtype=torch.float32)
    beta[::2] = 0
    dy = torch.tensor(rng.normal(0, 1, x.shape), dtype=dtype)
    return x, gamma, beta, dy


def _fused(x, gamma, beta):
    return tbn.bn_train(x, gamma, beta, relu=True)[0]


def _unfused(x, gamma, beta):
    """The packed step's conv-BN-ReLU tail as it was: ReLU as its own op."""
    return torch.relu(tbn.bn_train(x, gamma, beta)[0])


def _value_and_grads(fn, case, remat=False):
    x, gamma, beta, dy = case
    leaves = [t.clone().requires_grad_() for t in (x, gamma, beta)]
    y = checkpoint(fn, *leaves, use_reentrant=False) if remat \
        else fn(*leaves)
    return (y.detach(), *torch.autograd.grad(y, leaves, dy))


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("C", [3, 32, 40, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_train_relu_equals_relu_of_bn_train(dtype, C, remat):
    """y and the x, gamma and beta gradients of ``bn_train(...,
    relu=True)`` equal those of ``torch.relu(bn_train(...)[0])`` bit for
    bit, ties at y = 0 included; under ``torch.utils.checkpoint`` too."""
    case = _relu_case(C, dtype)
    want = _value_and_grads(_unfused, case)
    got = _value_and_grads(_fused, case, remat)
    assert (want[0] == 0).any() and (case[0] == 0).any()
    for name, g, w in zip(("y", "dx", "dgamma", "dbeta"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


def _dp_bn_rank(x, gamma, beta, dy):
    """One rank of ``test_bn_train_relu_on_two_gloo_ranks``: its half of
    the rows through ``bn_train(..., relu=True)`` under the data group."""
    rank, n = dist.get_rank(), dist.get_world_size()
    rows = slice(rank * len(x) // n, (rank + 1) * len(x) // n)
    xs, g, b = (t.clone().requires_grad_() for t in (x[rows], gamma, beta))
    with data_parallel(dist.group.WORLD):
        y, mean, var = tbn.bn_train(xs, g, b, relu=True)
        grads = torch.autograd.grad(y, (xs, g, b), dy[rows])
    return [t.detach() for t in (y, mean, var, *grads)]


def test_bn_train_relu_on_two_gloo_ranks():
    """On a two-rank gloo data group: both ranks read the global batch's
    statistics (those of one rank holding every row, to 1e-6: the sums are
    added in another order), y and dx their rows of the one-rank result,
    and the gamma and beta gradients are the rank's share: its own rows'
    masked sums, which add up over the ranks to the one-rank gradients."""
    x, gamma, beta, dy = (t.float() for t in _relu_case(16, torch.float32))
    ranks = run_ranks(_dp_bn_rank, 2, x, gamma, beta, dy, backend="gloo")
    xs, gs, bs = (t.clone().requires_grad_() for t in (x, gamma, beta))
    y, mean, var = tbn.bn_train(xs, gs, bs, relu=True)
    dx, dgamma, dbeta = torch.autograd.grad(y, (xs, gs, bs), dy)
    close = dict(rtol=1e-6, atol=1e-6)
    for r, (yr, mr, vr, dxr, dgr, dbr) in enumerate(ranks):
        assert torch.equal(mr, ranks[0][1]) and torch.equal(vr, ranks[0][2])
        torch.testing.assert_close(mr, mean, **close)
        torch.testing.assert_close(vr, var, **close)
        torch.testing.assert_close(yr, y[r:r + 1].detach(), **close)
        torch.testing.assert_close(dxr, dx[r:r + 1], **close)
        xr, dyr = x[r:r + 1], dy[r:r + 1]
        share = tbn.pair_sums_reference(dyr.masked_fill(yr <= 0, 0), xr)
        assert torch.equal(dbr, share[0])
        torch.testing.assert_close(dgr, (share[1] - mr * share[0])
                                   * torch.rsqrt(vr + tbn.EPS), **close)
    torch.testing.assert_close(ranks[0][5] + ranks[1][5], dbeta, **close)
    torch.testing.assert_close(ranks[0][4] + ranks[1][4], dgamma, **close)


def test_bn_train_runs_its_passes_by_name(monkeypatch):
    """``bn_train`` looks K6, K13 and K14 up by name at call time (what a
    swapped-in plain version or planted fault relies on): one ``pair_sums``
    and one ``bn_apply`` in the forward, one masked ``pair_sums`` and one
    ``bn_dx`` in the backward. On the CPU each wrapper is its plain version,
    and a channels-first view gives the contiguous input's y and
    gradients."""
    x, gamma, beta, dy = _relu_case(8, torch.bfloat16)
    view = x.permute(0, 3, 1, 2).contiguous().movedim(1, -1)
    assert not view.is_contiguous() and torch.equal(view, x)
    scale, shift = torch.rand(8) + 0.5, torch.randn(8)
    g, c1, c0 = torch.randn(3, 8)
    for inp in (x, view):
        assert torch.equal(tbn.bn_apply(inp, scale, shift, True),
                           tbn.bn_apply_reference(inp, scale, shift, True))
        assert torch.equal(
            tbn.bn_dx(dy, inp, g, c1, c0, (scale, shift)),
            tbn.bn_dx_reference(dy, inp, g, c1, c0, (scale, shift)))
    ran = []

    def spy(name):
        fn = getattr(tbn, name)

        def wrapped(*args, **kwargs):
            ran.append((name, kwargs.get("mask") is not None
                        or (name == "bn_dx" and args[-1] is not None)))
            return fn(*args, **kwargs)
        return wrapped

    for name in ("pair_sums", "bn_apply", "bn_dx"):
        monkeypatch.setattr(tbn, name, spy(name))
    got = _value_and_grads(_fused, (x, gamma, beta, dy))
    assert ran == [("pair_sums", False), ("bn_apply", False),
                   ("pair_sums", True), ("bn_dx", True)]
    for a, b in zip(_value_and_grads(_fused, (view, gamma, beta, dy)), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.float32])
def test_bn_kernels_refuse_what_they_cannot_take(dtype):
    """Off the CPU no plain version runs: a tensor that is not a float32
    or bfloat16 CUDA tensor (a meta tensor stands for one here: float16 and
    float64 refused for their dtype, all three for their device) raises in
    K13's, K14's and K6's wrappers, naming its dtype and device."""
    x = torch.empty((2, 4, 4, 8), dtype=dtype, device="meta")
    terms = torch.empty(8, device="meta")
    said = f"{dtype} on meta"
    with pytest.raises(ValueError, match=said):
        tbn.bn_apply(x, terms, terms, True)
    with pytest.raises(ValueError, match=said):
        tbn.bn_dx(x, x, terms, terms, terms)
    with pytest.raises(ValueError, match="meta"):
        tbn.pair_sums(x)


@pytest.mark.parametrize("m,c", [(1, 5), (24, 3), (100, 32), (7, 40),
                                 (2 * 64 * 64, 256), (9, 512), (33, 4096),
                                 (32 * 512 * 512, 32), (1000, 300)])
def test_apply_plan_covers_every_row_once(m, c):
    """``apply_plan``: the rows block g's thread row ry takes (g * rows_step
    + ry, then every grid * rows_step) cover [0, M) once; each channel
    group is taken by one lane; 8 channels a lane exactly where C % 8 == 0
    and aligned; the grid within the co-resident bound and no larger than
    the rows need."""
    for co_resident in (1, 7, 264, 1056):
        plan = tbn.apply_plan(m, c, co_resident=co_resident)
        assert plan.vec == (8 if c % 8 == 0 else 1)
        assert plan.lanes * plan.rows_step <= tbn.THREADS
        assert 1 <= plan.grid <= co_resident
        assert plan.grid <= -(-m // plan.rows_step)
        groups = c // plan.vec
        assert sorted(g for lane in range(plan.lanes)
                      for g in range(lane, groups, plan.lanes)) \
            == list(range(groups))
        # a thread's rows are one residue mod the grid's step: the first
        # rows of the threads are each residue once
        step = plan.grid * plan.rows_step
        starts = sorted(g * plan.rows_step + ry for g in range(plan.grid)
                        for ry in range(plan.rows_step))
        assert starts == list(range(step))
        if m <= 10 ** 5:
            rows = sorted(r for r0 in starts for r in range(r0, m, step))
            assert rows == list(range(m))
    assert tbn.apply_plan(64, 32, co_resident=9, aligned=False).vec == 1


@pytest.mark.parametrize("src,name", [
    ("bn_pair_sums.cu", "octseg_bn_pair_sums_masked"),
    ("bn_pair_sums.cu", "octseg_bn_pair_sums_masked_resident"),
    ("bn_apply.cu", "octseg_bn_apply"),
    ("bn_apply.cu", "octseg_bn_dx"),
    ("bn_apply.cu", "octseg_bn_apply_resident"),
])
def test_bn_kernel_bindings_match_the_c_entry_points(src, name):
    """As ``test_k6_binding_matches_the_c_entry_points``, for K6's masked
    mode and for K13 and K14."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    text = (_build.CSRC / src).read_text()
    params = re.search(rf'extern "C" int {name}\(([^)]*)\)',
                       text).group(1).split(",")
    argtypes = _build.SIGNATURES[name]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
        assert ("long long" in p) == (t is ctypes.c_longlong), (p, t)


def test_bn_plain_versions_hold_the_eager_formulas():
    """The plain versions of K13, K14 and K6's masked mode are the eager
    ops the step ran before: y = round(x * scale + shift) (ReLU'd), dx =
    round(dy_m * g - x * c1 - c0), and K6's sums over relu's zeroed dy."""
    x, gamma, beta, dy = _relu_case(24, torch.bfloat16, seed=3)
    rng = np.random.default_rng(4)
    scale, shift, g, c1, c0 = (torch.tensor(rng.normal(0, 1, 24),
                                            dtype=torch.float32)
                               for _ in range(5))
    y = (x.float() * scale + shift).to(x.dtype)
    assert torch.equal(tbn.bn_apply_reference(x, scale, shift), y)
    assert torch.equal(tbn.bn_apply_reference(x, scale, shift, True),
                       torch.relu(y))
    dym = torch.ops.aten.threshold_backward(dy, torch.relu(y), 0)
    assert torch.equal(tbn.relu_closed(x, scale, shift), y <= 0)
    assert torch.equal(tbn.bn_dx(dym, x, g, c1, c0),
                       (dym.float() * g - x.float() * c1 - c0).to(x.dtype))
    assert torch.equal(tbn.bn_dx(dy, x, g, c1, c0, (scale, shift)),
                       tbn.bn_dx_reference(dym, x, g, c1, c0))
    assert torch.equal(tbn.pair_sums(dy, x, mask=(scale, shift)),
                       tbn.pair_sums(dym, x))
    assert torch.equal(tbn.bn_apply(x, scale, shift, True), torch.relu(y))
