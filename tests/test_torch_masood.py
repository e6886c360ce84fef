"""The port's fixed filter banks, GLCM features and Masood 2024
(``ops/gabor.py``, ``ops/glcm.py``, ``models/masood.py``) against the JAX
package's: the Gabor and Haar banks equal, ``conv_same_torch``'s even
kernels padded (0, 1) as JAX pads them, the quantisation and the
co-occurrence matrices bit-equal (an image on the level boundaries too),
the 64 features at 1e-5 scale-relative; the model at 64x64, batch 2, in
eval and train mode at 1e-4 with the running statistics after the train
call; a branch's train-mode gradient against ``jax.grad``; the parameter
tree at the default width."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    masood as jmasood,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    gabor as jgabor,
    glcm as jglcm,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    masood,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    gabor,
    glcm,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from test_torch_common import (
    check_zoo_forward,
    check_zoo_gradient,
    default_tree_matches,
    jax_eval_train,
    jax_variables,
    nchw,
    normal_images,
)

NC, TOL, HW = 1, 1e-4, 64


def test_banks_equal_jax():
    assert gabor.gabor_bank().shape == (8, 8, 1, 48)
    np.testing.assert_array_equal(gabor.gabor_bank(), jgabor.gabor_bank())
    np.testing.assert_array_equal(gabor.haar_bank(), jgabor.haar_bank())
    assert glcm.reference_offsets() == jglcm.reference_offsets()


@pytest.mark.parametrize("bank", ["gabor", "haar"])
def test_conv_same_matches_jax(bank):
    """The 8x8 Gabor and 2x2 Haar kernels pad (3, 4) and (0, 1), as JAX's
    explicit padding does: at 1e-6, and the Haar bank's last row and
    column see the zero padding after the image."""
    x = normal_images(4, 2, 20)
    filters = getattr(gabor, f"{bank}_bank")()
    want = np.asarray(jgabor.conv_same_torch(jnp.asarray(x), filters))
    got = gabor.conv_same_torch(nchw(x), filters).numpy().transpose(
        0, 2, 3, 1)
    assert got.shape == want.shape == (2, 20, 20, filters.shape[-1])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    if bank == "haar":  # the vertical kernel [[1, -1], [1, -1]] at W - 1
        np.testing.assert_allclose(got[:, :-1, -1, 1],
                                   x[:, :-1, -1, 0] + x[:, 1:, -1, 0],
                                   rtol=1e-6)


def _images():
    """A seeded image, one with a constant region, and one whose values
    are k / 255 exactly (the quantisation's level boundaries)."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal((24, 20))
    b = a.copy()
    b[:8] = 0.25
    c = rng.integers(0, 256, (24, 20)) / 255.0
    c[0, 0], c[0, 1] = 0.0, 1.0
    return np.stack([a, b, c]).astype(np.float32)


def test_glcm_counts_and_features_match_jax():
    imgs = _images()
    q = glcm.quantize_reference(torch.from_numpy(imgs))
    want_q = np.stack([np.asarray(jglcm.quantize_reference(jnp.asarray(i)))
                       for i in imgs])
    np.testing.assert_array_equal(q.numpy(), want_q)
    assert q.dtype == torch.int32 and int(q.max()) <= 255
    for r, c in glcm.reference_offsets():
        got = glcm.glcm_single(q, r, c).numpy()
        for i in range(len(imgs)):
            want = np.asarray(jglcm._glcm_single(jnp.asarray(want_q[i]), r,
                                                 c))
            np.testing.assert_array_equal(got[i], want)
    feats = glcm.glcm_feature_vector(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jglcm.glcm_feature_vector(jnp.asarray(imgs)))
    assert feats.shape == want.shape == (3, 64)
    # contrast and variance reach ~1e4: each feature scale-relative
    for k in range(8):
        w = want[:, k::8]
        np.testing.assert_allclose(feats[:, k::8], w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@functools.lru_cache(maxsize=None)
def _jax_case():
    """The head's weights on the 64 GLCM channels are scaled by 1e-4:
    contrast and variance reach ~1e4, and at the drawn scale the sigmoid
    is 0 everywhere, which would hide every other input."""
    jm = jmasood.Masood2024(num_classes=NC)
    x = normal_images(1, 2, HW)
    v = jax_variables(jm, x)
    v["params"]["Conv_0"]["Conv_0"]["kernel"][:, :, -64:] *= 1e-4
    return (x, v) + tuple(jax_eval_train(jm, x, v))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_masood_forward(train):
    x, v, want_eval, want_train, stats = _jax_case()
    tm = masood.Masood2024(1, NC, generator=torch.Generator())
    (got,) = check_zoo_forward(tm, v, x, want_train if train else want_eval,
                               stats, train, TOL)
    assert 0.05 < float(got.mean()) < 0.95


def test_cnn_branch_gradient():
    """The family's gradient: one ``CNNBranch`` (five conv-BN-ReLU, three
    pools, the align_corners resize back) in train mode against
    ``jax.grad``."""
    jm = jmasood.CNNBranch()
    x = normal_images(2, 2, 32)
    v = jax_variables(jm, x)
    cot = np.random.default_rng(8).standard_normal((2, 32, 32, 64)).astype(
        np.float32)
    *_, grads = jax_eval_train(jm, x, v, cot)
    tm = masood.CNNBranch(1, generator=torch.Generator())
    lmap = [(f"convs.{j}", (f"Conv_{j}",), "conv") for j in range(5)] + [
        (f"bns.{j}", (f"BatchNorm_{j}",), "bn") for j in range(5)]
    zero = check_zoo_gradient(tm, v, x, cot, grads, TOL, lmap)
    assert zero <= 5  # at most the five conv biases before the BNs


def test_default_width_parameters():
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    default_tree_matches(jax_get_model("masood"), get_model("masood"), HW)
