"""K12's register body (``csrc/column_softargmax.cu:column_softargmax_regs``)
on the CPU: ``column_softargmax_plan`` (the register body and its rows a
thread for H <= 512, the three-pass body beyond, the grid, the tail
columns of a W that is not a multiple of 32), the C source's dispatch and
constants against the plan, and a float32 numpy emulation of the body's
order of operations (a thread's rows h = ty, ty + 16, ... Kahan-summed,
then the 16 warps' partials Kahan-summed in order), held within phase 22's
limits (sm 1e-6, pos and std 1e-5 * H) of the float64 plain version on
peaked, flat and one-hot columns, and against JAX's
``fused_column_softargmax`` in interpret mode. Imports JAX only inside the
test that compares with it.
"""

import re

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    _build,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    column_softargmax as k12,
)

F32 = np.float32


def _kahan(s, c, v):
    """(s, c) + v, as ``kahan_add``."""
    y = v - c
    t = s + y
    return t, (t - s) - y


def _kahan_sum(vals):
    """vals (n, ...) float32 Kahan-summed in order along axis 0, the
    compensation taken off at the end (``s - comp``)."""
    s = np.zeros(vals.shape[1:], F32)
    c = np.zeros_like(s)
    for v in vals:
        s, c = _kahan(s, c, v)
    return s - c


def emulate(x, rows):
    """The register body with ``rows`` rows a thread on x (B, L, H, W)
    float32 numpy: -> (sm, pos, std) float32."""
    B, L, H, W = x.shape
    RW = k12.ROW_WARPS
    planes = x.reshape(B * L, H, W).astype(F32)
    v = np.full((B * L, rows * RW, W), -np.inf, F32)
    v[:, :H] = planes
    # row h = ty + 16 r at [:, r, ty]
    v = v.reshape(B * L, rows, RW, W)
    h = np.arange(rows * RW, dtype=F32).reshape(rows, RW, 1)
    valid = h < H
    mx = v.max(axis=1).max(axis=1, keepdims=True)  # fmaxf: exact
    with np.errstate(invalid="ignore", over="ignore"):
        e = np.where(valid, np.exp(v - mx[:, None]), F32(0)).astype(F32)
    # each warp's partial over its rows, then the 16 partials in order
    total = _kahan_sum(np.moveaxis(_kahan_sum(np.moveaxis(e, 1, 0)), 1, 0))
    p = (e / total[:, None, None]).astype(F32)
    pos = _kahan_sum(np.moveaxis(
        _kahan_sum(np.moveaxis(p * h, 1, 0)), 1, 0))
    d = (h - pos[:, None, None]).astype(F32)
    var = _kahan_sum(np.moveaxis(
        _kahan_sum(np.moveaxis(p * d * d, 1, 0)), 1, 0))
    sm = p.reshape(B * L, rows * RW, W)[:, :H]
    return (sm.reshape(B, L, H, W), pos.reshape(B, L, W),
            np.sqrt(var).reshape(B, L, W))


def _columns(H):
    """(1, 1, H, 5) float32: a peaked column far down, a flat one, a
    one-hot one, a broad bump and N(0, 3) logits."""
    rng = np.random.default_rng(H)
    h = np.arange(H)
    cols = [-0.5 * ((h - 0.94 * H) / 0.7) ** 2,
            np.zeros(H),
            rng.standard_normal(H),
            -0.5 * ((h - 0.3 * H) / (0.1 * H + 1)) ** 2,
            rng.standard_normal(H) * 3]
    cols[2][H // 3] = 1e4  # one-hot: std exactly 0
    return np.stack(cols, axis=1)[None, None].astype(F32)


@pytest.mark.parametrize("H", [7, 100, 200, 512])
def test_emulation_meets_phase_22_limits(H):
    """The register body's order within 1e-6 (sm) and 1e-5 * H (pos, std)
    of the float64 plain version; the one-hot column gives std exactly 0
    and pos its row."""
    x = _columns(H)
    plan = k12.column_softargmax_plan(*x.shape)
    assert plan.body == "regs"
    got = emulate(x, plan.rows)
    want = k12.column_softargmax_reference(torch.from_numpy(x))
    for g, w, tol in zip(got, want, (1e-6, 1e-5 * H, 1e-5 * H)):
        assert g.shape == tuple(w.shape)
        assert np.abs(g - w.numpy()).max() <= tol
    assert got[2][0, 0, 2] == 0.0
    assert got[1][0, 0, 2] == H // 3
    # the flat column: p = 1 / H everywhere, pos = (H - 1) / 2
    assert np.abs(got[1][0, 0, 1] - (H - 1) / 2) <= 1e-5 * H


def test_emulation_matches_jax_interpret():
    """At a small shape, W not a multiple of 32 or 128, L = 3."""
    import jax.numpy as jnp

    from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_kernels import (
        fused_column_softargmax,
    )

    x = np.random.default_rng(5).standard_normal((2, 40, 37, 3)).astype(
        F32) * 2
    sm, pos, std = fused_column_softargmax(jnp.asarray(x), interpret=True)
    port = np.ascontiguousarray(x.transpose(0, 3, 1, 2))
    got = emulate(port, k12.column_softargmax_plan(*port.shape).rows)
    want = (np.asarray(sm).transpose(0, 3, 1, 2),
            np.asarray(pos).transpose(0, 2, 1),
            np.asarray(std).transpose(0, 2, 1))
    for g, w, tol in zip(got, want, (1e-6, 1e-5 * 40, 1e-5 * 40)):
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)


@pytest.mark.parametrize("H,body,rows", [
    (1, "regs", 8), (7, "regs", 8), (128, "regs", 8), (129, "regs", 16),
    (256, "regs", 16), (257, "regs", 32), (512, "regs", 32),
    (513, "three_pass", 0), (600, "three_pass", 0), (4096, "three_pass", 0),
])
@pytest.mark.parametrize("W", [40, 64, 512])
def test_plan_body_and_rows(H, body, rows, W):
    """The register body with the fewest of 8, 16, 32 rows that holds
    ceil(H / 16) rows a thread; the three-pass body past H = 512. The
    register body's instance without predicates where every thread's rows
    and every strip's columns exist (H = 16 R, W % 32 == 0)."""
    plan = k12.column_softargmax_plan(2, 3, H, W)
    assert (plan.body, plan.rows) == (body, rows)
    assert plan.block == (32, 16)
    assert plan.full == (body == "regs" and H == 16 * rows and W % 32 == 0)
    if body == "regs":
        assert 16 * rows >= H and (rows == 8 or 8 * rows < H)
    assert plan.text().startswith(body)
    assert ("full" in plan.text()) == plan.full


def test_plan_takes_three_pass_for_planes_past_32_bit_offsets():
    """The register body's offsets in a plane are 32-bit."""
    assert k12.column_softargmax_plan(1, 1, 512, 2 ** 22 - 32).body == "regs"
    assert k12.column_softargmax_plan(1, 1, 512, 2 ** 22).body == \
        "three_pass"


@pytest.mark.parametrize("W", [1, 31, 32, 33, 200, 512])
def test_plan_grid_covers_every_column_once(W):
    """grid (ceil(W / 32), B * L): column w of a plane in strip w // 32,
    lane w % 32; the last strip holds W % 32 live columns (all 32 where W
    is a multiple of 32)."""
    B, L = 2, 3
    plan = k12.column_softargmax_plan(B, L, 64, W)
    assert plan.grid == (-(-W // 32), B * L)
    seen = np.zeros(W, int)
    for bx in range(plan.grid[0]):
        live = [bx * 32 + tx for tx in range(plan.block[0])
                if bx * 32 + tx < W]
        if bx == plan.grid[0] - 1:
            assert len(live) == (W % 32 or 32)
        seen[live] += 1
    assert (seen == 1).all()


def test_source_dispatch_matches_the_plan():
    """``body_for`` in the source takes the bodies at the plan's
    thresholds; the block and the binding are the plan's."""
    src = (_build.CSRC / "column_softargmax.cu").read_text()
    assert re.search(rf"constexpr int COLS = {k12.COLS};", src)
    assert re.search(rf"constexpr int RW = {k12.ROW_WARPS};", src)
    assert re.search(r"constexpr int MAX_REGS_H = 512;", src)
    body = re.search(r"Body body_for\(int H, int W\) \{(.*?)\n\}", src,
                     re.S).group(1)
    assert re.findall(r"regs_for<(\d+)>", body) == \
        [str(r) for r in k12.REG_ROWS]
    assert "RW * 8" in body and "RW * 16" in body and "MAX_REGS_H" in body
    assert "(long long)H * W >= (1LL << 31)" in body
    assert body.count("column_softargmax_three_pass") == 2
    full = re.search(r"Body regs_for\(int H, int W\) \{(.*?)\n\}", src,
                     re.S).group(1)
    assert "H == RW * R && W % COLS == 0" in full
    params = re.search(r'extern "C" int octseg_column_softargmax\(([^)]*)\)',
                       src).group(1).split(",")
    assert len(params) == len(_build.SIGNATURES["octseg_column_softargmax"])
