"""K12's plain version (``ops/column_softargmax``) against the JAX package's
``fused_column_softargmax`` (Pallas, interpret mode) and
``reference_column_softargmax``, and its analytic backward against
``jax.vjp`` of the reference.

The port's layout is (B, L, H, W); the JAX functions take (B, H, W, L), so
the inputs are transposed at this boundary. The tolerances of the forward
are the JAX kernel test's (``tests/test_pallas_kernels.py``): sm 1e-5, pos
and std 1e-4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_kernels import (
    fused_column_softargmax,
    reference_column_softargmax,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.column_softargmax import (
    column_softargmax,
    column_softargmax_forward,
    column_softargmax_reference,
)

# (B, H, W, L) in the JAX layout: W not a multiple of 128, and L = 11
SHAPES = [(2, 16, 200, 3), (1, 32, 40, 11)]


def _to_port(a):
    """(B, H, W, L) -> (B, L, H, W)."""
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_version_matches_jax(shape):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32) * 2
    sm, pos, std = column_softargmax_forward(_to_port(x))
    assert sm.shape == (shape[0], shape[3], shape[1], shape[2])
    assert pos.shape == std.shape == (shape[0], shape[3], shape[2])
    got = (sm.numpy().transpose(0, 2, 3, 1), pos.numpy().transpose(0, 2, 1),
           std.numpy().transpose(0, 2, 1))
    for want in (fused_column_softargmax(jnp.asarray(x), interpret=True),
                 reference_column_softargmax(jnp.asarray(x))):
        for g, w, tol in zip(got, want, (1e-5, 1e-4, 1e-4)):
            np.testing.assert_allclose(g, np.asarray(w), atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("with_std", [True, False])
def test_backward_matches_jax_vjp(shape, with_std):
    """dx from random cotangents of (sm, pos[, std]) against ``jax.vjp``,
    within 1e-5 of the largest |dx|; without a std cotangent JAX is given
    zeros, the port none (the SDNet trainer never uses std)."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32) * 2
    B, H, W, L = shape
    g_sm = rng.standard_normal(shape).astype(np.float32)
    g_pos = rng.standard_normal((B, W, L)).astype(np.float32)
    g_std = rng.standard_normal((B, W, L)).astype(np.float32)
    if not with_std:
        g_std = np.zeros_like(g_std)
    _, vjp = jax.vjp(reference_column_softargmax, jnp.asarray(x))
    (want,) = vjp((jnp.asarray(g_sm), jnp.asarray(g_pos), jnp.asarray(g_std)))
    want = np.asarray(want).transpose(0, 3, 1, 2)

    xt = _to_port(x).requires_grad_(True)
    sm, pos, std = column_softargmax(xt)
    loss = (torch.sum(sm * _to_port(g_sm))
            + torch.sum(pos * torch.from_numpy(g_pos.transpose(0, 2, 1))))
    if with_std:
        loss = loss + torch.sum(
            std * torch.from_numpy(g_std.transpose(0, 2, 1)))
    loss.backward()
    err = np.abs(xt.grad.numpy() - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


def test_one_hot_column_without_std_cotangent_is_finite():
    """A column whose softmax is one-hot has std = 0: a std cotangent would
    give 0/0, so an absent one must leave the gradient finite."""
    x = np.random.default_rng(2).standard_normal((1, 2, 24, 5)).astype(
        np.float32)
    x[0, 1, 7, 3] = 1e4  # column (1, 3): one-hot at row 7
    xt = torch.from_numpy(x).requires_grad_(True)
    sm, pos, std = column_softargmax(xt)
    assert float(std[0, 1, 3].detach()) == 0.0
    assert float(pos[0, 1, 3].detach()) == 7.0
    (torch.sum(sm * torch.linspace(-1, 1, 24).view(1, 1, 24, 1))
     + torch.sum(pos)).backward()
    assert torch.isfinite(xt.grad).all()
    # the plain version's autograd agrees where both are defined
    xr = torch.from_numpy(x).requires_grad_(True)
    sr, pr, _ = column_softargmax_reference(xr)
    (torch.sum(sr * torch.linspace(-1, 1, 24).view(1, 1, 24, 1))
     + torch.sum(pr)).backward()
    torch.testing.assert_close(xt.grad, xr.grad, rtol=1e-5, atol=1e-6)


def test_centred_std_keeps_float32_precision():
    """At H = 512 a narrow column far down the image: E[h^2] - pos^2 would
    cancel in float32; the centred form stays within 1e-4 of float64."""
    H = 512
    h = np.arange(H)
    logits = -0.5 * ((h - 480.3) / 0.7) ** 2
    x = torch.tensor(logits, dtype=torch.float32).view(1, 1, H, 1)
    _, pos, std = column_softargmax_forward(x)
    p = np.exp(logits - logits.max())
    p /= p.sum()
    mu = (p * h).sum()
    sd = np.sqrt((p * (h - mu) ** 2).sum())
    assert abs(float(pos) - mu) < 1e-3
    assert abs(float(std) - sd) < 1e-4
