"""The port's index max-pool and max-unpool (``ops/pooling.py``) against the
JAX package's ``ops/pooling.py``, on int8 and float inputs with planted
ties (the first maximum in window order wins in both)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pooling import (
    max_pool_argmax as jax_pool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pooling import (
    max_unpool as jax_unpool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.pooling import (
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
