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


PLAN_CASES = [(1, 8, 16, 16, 32), (8, 512, 512, 32, 32),
              (8, 32, 32, 512, 512)]
# the default train step's three K5 calls (batch 8, 512^2)
MAIN_PATH = [(8, 512, 512, 32, 32), (8, 512, 512, 64, 32),
             (8, 512, 512, 32, 32)]


@pytest.mark.parametrize("n,h,w,cin,cout", PLAN_CASES)
def test_wgrad_groups_bound_the_grid(n, h, w, cin, cout):
    """K5's plan: at most about two blocks per SM of an H100 in all (or one
    per channel tile), its tiles within the kernel's limits, and the bands
    of every block, over every channel tile, cover each (n, row, column
    tile, ci, co) exactly once, each block walking its bands in the fixed
    (n, row, column) order."""
    plan = k45.wgrad_plan(n, h, w, cin, cout)
    tiles = plan.n_ci * plan.n_co
    assert 1 <= plan.G <= plan.units
    assert plan.G * tiles <= max(2 * 132, tiles)
    assert plan.twk % 16 == 0 and plan.twk <= 128
    assert plan.ci_t in (16, 32, 64) and plan.co_t == 32
    assert plan.ci_t * plan.co_t <= 2048
    # the grid is (G, n_ci, n_co): block (g, i, j) takes g's bands for
    # channel tile (i, j), so each (n, row, column tile, ci, co) is covered
    # (blocks g that cover its pixels) x (tiles that cover its channels)
    # times
    pixels = np.zeros((n, h, plan.nct), np.int32)
    for g in range(plan.G):
        order = plan.order(g)
        assert order == sorted(order) and len(set(order)) == len(order)
        for b_n, y0, x0 in order:
            assert y0 % plan.R == 0 and x0 % plan.twk == 0
            pixels[b_n, y0:y0 + plan.R, x0 // plan.twk] += 1
    ci = np.zeros(plan.n_ci * plan.ci_t, np.int32)
    co = np.zeros(plan.n_co * plan.co_t, np.int32)
    for i in range(plan.n_ci):
        ci[i * plan.ci_t:(i + 1) * plan.ci_t] += 1
    for j in range(plan.n_co):
        co[j * plan.co_t:(j + 1) * plan.co_t] += 1
    assert (pixels == 1).all() and (ci == 1).all() and (co == 1).all()
    assert plan.nct * plan.twk >= w > (plan.nct - 1) * plan.twk
    assert plan.n_ci * plan.ci_t >= cin and plan.n_co * plan.co_t >= cout


@pytest.mark.parametrize("n,h,w,cin,cout", MAIN_PATH)
def test_wgrad_plan_reads_each_byte_once(n, h, w, cin, cout):
    """At the default step's shapes the channel tile is all of cin and cout:
    dy is read once, x at most (R+2)/R * (twk+2)/twk times (the halo rows
    and columns)."""
    plan = k45.wgrad_plan(n, h, w, cin, cout)
    assert (plan.n_ci, plan.n_co) == (1, 1)
    x_reads, dy_reads = plan.reads()
    assert dy_reads == 1.0
    assert 1.0 < x_reads <= (plan.R + 2) / plan.R * (plan.twk + 2) / plan.twk


@pytest.mark.parametrize("cin,cout", [(5, 3), (24, 40), (8, 16)])
def test_wgrad_on_padded_channels(cin, cout):
    """K5's wrapper pads the channels to a multiple of 8 and slices dW: the
    plain version on the zero-padded x and dy, sliced back, equals the plain
    version on the originals."""
    rng = np.random.default_rng(cin * 10 + cout)
    x = _bf16(rng.standard_normal((2, 6, 10, cin)))
    dy = _bf16(rng.standard_normal((2, 6, 10, cout)))
    xp, dyp = k45.pad_channels(x), k45.pad_channels(dy)
    assert xp.shape[-1] % 8 == 0 and dyp.shape[-1] % 8 == 0
    assert xp.shape[-1] - cin < 8 and dyp.shape[-1] - cout < 8
    assert xp.is_contiguous() and xp.data_ptr() % 16 == 0
    assert k45.pad_channels(xp) is xp
    if cin % 8 == 0:
        assert xp is x
    want = k45.conv3x3_bf16_wgrad_reference(x, dy)
    got = k45.conv3x3_bf16_wgrad_reference(xp, dyp)[..., :cin, :cout]
    assert torch.equal(got, want)


def test_pad_channels_copies_a_misaligned_tensor():
    """A contiguous bf16 tensor 2 bytes off a 16-byte boundary is copied to
    an aligned one, values unchanged."""
    base = torch.arange(1 + 2 * 2 * 8, dtype=torch.bfloat16)
    t = base[1:].view(1, 2, 2, 8)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    got = k45.pad_channels(t)
    assert got.data_ptr() % 16 == 0 and torch.equal(got, t)


def test_wgrad_binding_matches_the_c_entry_point():
    """The ctypes argument list of K5 (``ops/_build.py``) has one entry per
    parameter of its C entry point, pointers where the C side takes
    pointers (a mismatch would show only on the card)."""
    import ctypes
    import re

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    src = (_build.CSRC / "conv3x3_bf16.cu").read_text()
    params = re.search(r'extern "C" int octseg_conv3x3_bf16_wgrad\(([^)]*)\)',
                       src).group(1).split(",")
    argtypes = _build.SIGNATURES["octseg_conv3x3_bf16_wgrad"]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        assert ("*" in p) == (t is ctypes.c_void_p), (p, t)
