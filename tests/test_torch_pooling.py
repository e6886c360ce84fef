"""The port's index max-pool and max-unpool (``ops/pooling.py``) against the
JAX package's ``ops/pooling.py``, on int8 and float inputs with planted
ties (the first maximum in window order wins in both); and the plain
``max_pool`` where H or W is not a multiple of k (MGU-Net's graph
reasoning pools a 5x5 map by 2 and 3): JAX's 'VALID' window, forward and
gradient, the gradient to the first maximum of a tied window."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pooling import (
    max_pool_argmax as jax_pool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pooling import (
    max_pool as jax_max_pool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pooling import (
    max_unpool as jax_unpool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.pooling import (
    max_pool,
    max_pool_argmax,
    max_unpool,
)


def _with_ties(dtype):
    rng = np.random.default_rng(0)
    x = rng.integers(-4, 5, (2, 8, 12, 3)).astype(dtype)  # many ties
    x[0, 0:2, 0:2, 0] = 3          # a whole window tied
    x[1, 2:4, 4:6, 1] = [[1, 7], [7, 7]]  # a maximum tied three ways
    return x


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_pool_and_unpool_match_jax(dtype):
    x = _with_ties(dtype)
    want_p, want_i = jax_pool(jnp.asarray(x))
    got_p, got_i = max_pool_argmax(torch.from_numpy(x))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert int(got_i[0, 0, 0, 0]) == 0 and int(got_i[1, 1, 2, 1]) == 1
    want_u = jax_unpool(want_p, want_i)
    got_u = max_unpool(got_p, got_i)
    assert got_u.dtype == got_p.dtype
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


@pytest.mark.parametrize("k,hw", [(2, (5, 5)), (3, (5, 7)), (5, (11, 5)),
                                  (3, (9, 6))], ids=str)
def test_max_pool_floor_matches_jax_with_its_gradient(k, hw):
    """Values and gradient against JAX's ``max_pool`` (``reduce_window``
    where H or W is not a multiple of k) on small integers, so that most
    windows tie; a whole window tied in its first cell."""
    import jax

    x = np.random.default_rng(k).integers(-2, 3, (2, *hw, 3)).astype(
        np.float32)
    x[0, :k, :k, 0] = 2.0  # the first window, all tied
    want, vjp = jax.vjp(lambda t: jax_max_pool(t, k), jnp.asarray(x))
    g = np.random.default_rng(9).standard_normal(want.shape).astype(
        np.float32)
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(
        True)
    got = max_pool(xt, k)
    got.backward(torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(got.detach().numpy().transpose(0, 2, 3, 1),
                                  np.asarray(want))
    dx = xt.grad.numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(dx, np.asarray(vjp(g)[0]))
    if hw[0] % k or hw[1] % k:  # the first of the tied cells takes it all
        assert dx[0, 0, 0, 0] == g[0, 0, 0, 0]
        assert not dx[0, :k, :k, 0].ravel()[1:].any()
