"""The port's bf16 training conv (``ops/conv_bf16``: K4 forward and dgrad,
K5 wgrad) against the JAX package's ``conv3x3_psrp_bf16`` with its Pallas
kernels in interpret mode, through ``pack_psrp``/``unpack_psrp``.

On the CPU the wrappers take their plain versions, so this holds the
arithmetic the CUDA kernels are compared with on the card. Inputs are small
integers: every fp32 partial sum is exact, so forward, dx and dw are
bit-equal (the JAX tests' own device, ``tests/test_bf16_conv.py:30-32``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_bf16 import (
    conv3x3_psrp_bf16,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pallas_conv_psrp import (
    pack_psrp,
    unpack_psrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_bf16 as k45,
)

CASES = [  # (by, nph, cin, cout, H, W): JAX's packing, and the image size
    (4, 4, 8, 8, 16, 16),
    (2, 2, 8, 16, 16, 16),
    (1, 1, 16, 8, 16, 16),
    (2, 2, 8, 8, 24, 16),  # non-square
]


def _ints(rng, shape, lo=-2, hi=3):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _bf16(a):
    return torch.tensor(a, dtype=torch.bfloat16)


def _jax_fwd_and_grads(x, w, dy, by, nph):
    """JAX forward, dx and dw (dw in bf16, as its VJP casts to w.dtype)."""
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)

    def f(x_, w_):
        y = conv3x3_psrp_bf16(pack_psrp(x_, by, nph), w_, by, nph, 2, True)
        return unpack_psrp(y, by, nph)

    y, vjp = jax.vjp(f, xj, wj)
    dx, dw = vjp(jnp.asarray(dy, jnp.bfloat16))
    return (np.asarray(y, np.float32), np.asarray(dx, np.float32),
            np.asarray(dw, np.float32))


@pytest.mark.parametrize("by,nph,cin,cout,H,W", CASES)
def test_plain_versions_bit_equal_to_jax(by, nph, cin, cout, H, W):
    rng = np.random.default_rng(cin * 100 + cout + H)
    x = _ints(rng, (2, H, W, cin))
    w = _ints(rng, (3, 3, cin, cout))
    dy = _ints(rng, (2, H, W, cout))
    y_j, dx_j, dw_j = _jax_fwd_and_grads(x, w, dy, by, nph)

    xt, wt, dyt = _bf16(x), _bf16(w), _bf16(dy)
    np.testing.assert_array_equal(
        k45.conv3x3_bf16_reference(xt, wt).float().numpy(), y_j)
    np.testing.assert_array_equal(
        k45.conv3x3_bf16_dgrad_reference(dyt, wt).float().numpy(), dx_j)
    dw = k45.conv3x3_bf16_wgrad_reference(xt, dyt)
    assert dw.dtype == torch.float32 and dw.shape == (3, 3, cin, cout)
    np.testing.assert_array_equal(dw.bfloat16().float().numpy(), dw_j)

    # the differentiable op: forward through the K4 wrapper, backward
    # through the K4 (on flipped weights) and K5 wrappers
    xg, wg = xt.clone().requires_grad_(), wt.clone().requires_grad_()
    y = k45.conv3x3_bf16(xg, wg)
    gx, gw = torch.autograd.grad(y, (xg, wg), dyt)
    assert y.dtype == gx.dtype == gw.dtype == torch.bfloat16
    np.testing.assert_array_equal(y.detach().float().numpy(), y_j)
    np.testing.assert_array_equal(gx.float().numpy(), dx_j)
    np.testing.assert_array_equal(gw.float().numpy(), dw_j)


def test_dgrad_is_forward_on_flipped_weights():
    """K4 serves as the dgrad: the forward plain version on ``flip_w(w)``
    equals the independent transposed-conv plain version."""
    rng = np.random.default_rng(3)
    dy = _bf16(_ints(rng, (2, 8, 12, 6)))
    w = _bf16(_ints(rng, (3, 3, 5, 6)))
    assert k45.flip_w(w).shape == (3, 3, 6, 5)
    assert torch.equal(k45.conv3x3_bf16_fwd(dy, k45.flip_w(w)),
                       k45.conv3x3_bf16_dgrad_reference(dy, w))


def test_wrappers_check_their_inputs():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="bf16"):
        k45.conv3x3_bf16(x, torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="device"):
        k45.conv3x3_bf16_fwd(torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16,
                                         device="meta"),
                             torch.zeros(3, 3, 8, 8, dtype=torch.bfloat16))


@pytest.mark.parametrize("n,h,w,cin,cout", [(1, 8, 16, 16, 32),
                                             (8, 512, 512, 32, 32),
                                             (8, 32, 32, 512, 512)])
def test_wgrad_groups_bound_the_grid(n, h, w, cin, cout):
    """K5's first pass: at most about 2048 blocks, at least one, and never
    more pixel groups than 8x16 output tiles."""
    g = k45.wgrad_groups(n, h, w, cin, cout)
    channel_tiles = -(-cin // 16) * -(-cout // 32)
    assert 1 <= g <= n * -(-h // 8) * -(-w // 16)
    assert g * channel_tiles <= max(2048, channel_tiles)
