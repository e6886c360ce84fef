"""The port's padding, resize and preprocessing (``ops/padding.py``,
``ops/resize.py``, ``ops/preprocess.py``) against the JAX package's on the
same seeded numpy inputs: pads, resizes and the blur within 1e-6, surfaces
equal, ``preprocess`` within 1e-5 (the port sums the z-score's statistics
in float64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    padding as jpad,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    preprocess as jpre,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    resize as jres,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    padding as tpad,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    preprocess as tpre,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    resize as tres,
)


def _images(shape=(2, 20, 24, 3), seed=0, dtype=np.float32):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(dtype)


def _both(jfn, tfn, x, *args, **kw):
    want = np.asarray(jfn(jnp.asarray(x), *args, **kw))
    got = tfn(torch.from_numpy(x), *args, **kw).numpy()
    return got, want


def _bscans(b=2, h=48, w=40, seed=1):
    """B-scans with a clear surface: dark vitreous above a bright retina
    whose top row varies smoothly by column, plus speckle."""
    rng = np.random.default_rng(seed)
    cols = np.arange(w)
    x = np.empty((b, h, w, 1), np.float32)
    for i in range(b):
        top = (h * 0.3 + 6 * np.sin(cols / w * 2 * np.pi + i)).astype(int)
        rows = np.arange(h)[:, None]
        retina = rows >= top[None, :]
        x[i, ..., 0] = np.where(retina, 180.0, 15.0) \
            * (1 + 0.1 * rng.standard_normal((h, w)))
    return x


# ---------------------------------------------------------------- padding


@pytest.mark.parametrize("name", ["reflect_pad_2d", "zero_pad_2d",
                                  "replicate_pad_2d"])
@pytest.mark.parametrize("pad", [1, (2, 0, 3, 1), (5, 6, 1, 2)])
@pytest.mark.parametrize("dtype", [np.float32, np.int32])
def test_pads_match_jax(name, pad, dtype):
    x = _images(dtype=np.float32) * 100
    got, want = _both(getattr(jpad, name), getattr(tpad, name),
                      x.astype(dtype), pad)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ----------------------------------------------------------------- resize


SIZES = [(1, 1), (1, 7), (7, 9), (13, 5), (33, 47), (40, 48), (64, 64),
         (57, 23)]


@pytest.mark.parametrize("out_hw", SIZES)
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_bilinear_matches_jax(out_hw, align_corners):
    got, want = _both(jres.resize_bilinear, tres.resize_bilinear,
                      _images(), out_hw, align_corners)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("out_hw", SIZES)
def test_resize_nearest_matches_jax(out_hw):
    got, want = _both(jres.resize_nearest, tres.resize_nearest, _images(),
                      out_hw)
    np.testing.assert_array_equal(got, want)


def test_source_grids_are_float32_as_jax():
    """Sizes where a float64 source coordinate floors to another
    neighbour than JAX's float32 one: the port picks JAX's."""
    found = 0
    for n_in in range(2, 200):
        for n_out in range(2, 200):
            d = np.arange(n_out)
            s32 = np.floor(d.astype(np.float32) * np.float32(n_in / n_out))
            s64 = np.floor(d * (n_in / n_out))
            if (s32 != s64).any():
                want = np.asarray(jres._nearest_indices(n_out, n_in))
                got = tres._nearest_indices(n_out, n_in, "cpu").numpy()
                np.testing.assert_array_equal(got, want)
                found += 1
                if found == 3:
                    return
    pytest.fail("no size where the float32 grid differs")


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("scale", [2, 3])
def test_upsample_matches_jax(mode, align_corners, scale):
    got, want = _both(jres.upsample, tres.upsample, _images(), scale, mode,
                      align_corners)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_upsample_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown mode"):
        tres.upsample(torch.zeros(1, 2, 2, 1), 2, "bicubic")


def test_resize_bilinear_keeps_the_dtype():
    x = torch.from_numpy(_images()).to(torch.bfloat16)
    assert tres.resize_bilinear(x, (7, 9)).dtype == torch.bfloat16


# ------------------------------------------------------------- preprocess


@pytest.mark.parametrize("shape", [(2, 20, 24, 1), (1, 17, 9, 2)])
def test_gaussian_blur_matches_jax(shape):
    got, want = _both(jpre.gaussian_blur_3x3, tpre.gaussian_blur_3x3,
                      _images(shape) * 255)
    np.testing.assert_allclose(got, want, atol=1e-6 * 255, rtol=0)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_estimate_surface_equals_jax(seed):
    x = _bscans(seed=seed)
    got, want = _both(jpre.estimate_surface, tpre.estimate_surface, x)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("w", [40, 41])
def test_flatten_retina_matches_jax(w):
    x = _bscans(w=w)
    got, want = _both(jpre.flatten_retina, tpre.flatten_retina, x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_flatten_even_width_takes_the_mean_of_the_middle_pair():
    """An even width whose two middle surface rows differ by an odd count:
    JAX's median averages them and truncates (torch.median would take the
    lower); rows wrap by floor-mod H."""
    b, h, w = 2, 16, 6
    x = np.random.default_rng(4).uniform(0, 1, (b, h, w, 1))
    x = x.astype(np.float32)
    surface = np.array([[1, 2, 3, 6, 9, 12], [0, 0, 5, 8, 15, 15]],
                       np.int32)  # middle pairs (3, 6) and (5, 8)
    got, want = _both(jpre.flatten_retina, tpre.flatten_retina, x,
                      surface)
    np.testing.assert_array_equal(got, want)
    target = tpre._median_row(torch.from_numpy(surface))
    assert target.flatten().tolist() == [4, 6]
    assert torch.median(torch.from_numpy(surface), dim=1).values.tolist() \
        == [3, 5]


PRE = [{}, {"normalize": False}, {"flatten": True}, {"denoise": True},
       {"flatten": True, "denoise": True},
       {"flatten": True, "denoise": True, "out_hw": (32, 24)},
       {"out_hw": (48, 40)}, {"out_hw": (20, 30), "normalize": False}]


@pytest.mark.parametrize("kw", PRE, ids=lambda kw: "-".join(kw) or "none")
def test_preprocess_matches_jax(kw):
    got, want = _both(jpre.preprocess, tpre.preprocess, _bscans(), **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_preprocess_returns_contiguous_tensors():
    """A strided input (a transposed view) comes out contiguous, as the
    graphs' kernels need, with the same values."""
    x = torch.from_numpy(np.ascontiguousarray(
        _bscans().transpose(0, 2, 1, 3))).transpose(1, 2)
    assert not x.is_contiguous()
    for kw in ({}, {"flatten": True, "denoise": True}):
        got = tpre.preprocess(x, **kw)
        assert got.is_contiguous()
        np.testing.assert_array_equal(
            got.numpy(), tpre.preprocess(x.contiguous(), **kw).numpy())


def test_preprocess_surfaces_survive_the_pipeline():
    """The surfaces the pipeline flattens to are JAX's: after flattening,
    every column's surface sits on the median row."""
    x = _bscans(b=3, seed=7)
    flat = tpre.preprocess(torch.from_numpy(x), flatten=True,
                           normalize=False)
    s0 = tpre.estimate_surface(torch.from_numpy(x))
    target = tpre._median_row(s0)
    s1 = tpre.estimate_surface(flat)
    assert (s1 == target).float().mean() > 0.95
    np.testing.assert_array_equal(
        s0.numpy(), np.asarray(jpre.estimate_surface(jnp.asarray(x))))
