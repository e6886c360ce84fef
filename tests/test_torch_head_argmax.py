"""K3 (1x1 head + argmax) of the PyTorch port: its plain version against the
JAX package's ``head_argmax_psrp`` Pallas kernel in interpret mode,
including pixels where two classes tie exactly (lowest class wins)."""

import numpy as np
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    pallas_conv_psrp as jp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.head_argmax import (
    head_argmax,
    pack_head_weights,
)
from test_torch_common import rand_int8


def test_k3_vs_head_argmax_psrp_with_ties():
    rng = np.random.default_rng(0)
    by = nph = 4
    cin, nc = 8, 6
    H = W = 16
    x = rand_int8(rng, (2, H, W, cin))
    w = rand_int8(rng, (1, 1, cin, nc), -20, 20)
    scale = rng.uniform(1e-3, 2e-3, nc).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, nc).astype(np.float32)
    # classes 1 and 4 are identical and favoured: every pixel where they
    # win is an exact tie, which must go to class 1
    w[..., 4] = w[..., 1]
    scale[4] = scale[1]
    bias[1] = bias[4] = 2.0
    # an all-zero pixel row: logits = bias exactly
    x[0, 0] = 0
    want = jp.head_argmax_psrp(
        jp.pack_psrp(jnp.asarray(x), by, nph),
        jnp.asarray(jp.pack_head_psrp_weights(w, by, ncp=8)),
        scale, bias, by=by, nph=nph, nc=nc, tg=2, interpret=True,
    )
    wk = pack_head_weights(torch.from_numpy(
        np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    ))
    got = head_argmax(torch.from_numpy(x), wk, torch.from_numpy(scale),
                      torch.from_numpy(bias))
    assert got.dtype == torch.int8 and got.shape == (2, H, W)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == 1).any() and not (got.numpy() == 4).any()
    assert (got.numpy()[0, 0] == 1).all()
