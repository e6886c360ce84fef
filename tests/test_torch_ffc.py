"""The port's FFC stack (``models/ffc.py``), its sampling and pooling ops and
the shared blocks it adds, against the JAX package on the same
numpy-seeded inputs and the same (randomized) weights, carried by
``utils/convert.layer_map``: 1e-4 scale-relative in eval mode and in train
mode (batch statistics; the running statistics after the call too)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    blocks as jblocks,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    ffc as jffc,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    pooling as jpool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    sampling as jsampling,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    blocks,
    ffc,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    pooling,
    sampling,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    layer_map,
    state_dict_from_jax,
    variables_from_state_dict,
)
from test_torch_common import jax_variables, nchw, scale_rel, tree_shapes

TOL = 1e-4
HW = 16


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _stream(rng, cin, n=2, hw=HW):
    cl, cg = cin
    draw = lambda c: rng.standard_normal((n, hw, hw, c)).astype(np.float32)
    return draw(cl), (draw(cg) if cg else None)


def _port(module, variables):
    module.load_state_dict(state_dict_from_jax(variables,
                                               layer_map(module)))
    return module


def _jax_both(jm, variables, x):
    """(eval outputs, train outputs, batch_stats after the train call) of
    the Flax module, one compile for both modes."""
    def both(v, x):
        train, mutated = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return jm.apply(v, x, train=False), train, mutated["batch_stats"]

    return jax.jit(both)(variables, x)


@functools.lru_cache(maxsize=None)
def _unit(case):
    """(input stream, JAX variables, ``_jax_both``) of an ``UNITS`` case or
    the resnet block, computed once for both modes' tests."""
    if case == "resnet":
        x = _stream(np.random.default_rng(1), ffc.split_channels(16, 0.75))
        jm = jffc.FFCResnetBlock(16, 0.75, 0.75)
    else:
        k, s, p, lfu, cin, r_in, r_out = case
        x = _stream(np.random.default_rng(cin + 10 * k + s),
                    ffc.split_channels(cin, r_in))
        jm = jffc.FFC_BN_ACT(16, k, r_in, r_out, s, p, act="relu",
                             enable_lfu=lfu)
    v = jax_variables(jm, x)
    return x, v, _jax_both(jm, v, x)


def _check_both(tm, case, train):
    """The port module in eval or train mode against the cached JAX
    outputs; after a train call, the running statistics too."""
    x, v, (want_eval, want_train, stats) = _unit(case)
    _port(tm, v)
    with torch.no_grad():
        got = tm.train(train)(tuple(map(nchw, x)))
    _assert_stream(got, want_train if train else want_eval)
    if train:
        _assert_stats(tm, stats)
    return got


def _assert_stream(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is not None:
            assert scale_rel(g, w) <= TOL


def _assert_stats(tm, batch_stats):
    got = variables_from_state_dict(tm.state_dict(), layer_map(tm))
    want = jax.tree.map(np.asarray, batch_stats)
    gs, ws = dict(jax.tree_util.tree_leaves_with_path(got["batch_stats"])), \
        jax.tree_util.tree_leaves_with_path(want)
    assert len(gs) == len(ws)
    for path, w in ws:
        assert scale_rel(gs[path], w) <= TOL, jax.tree_util.keystr(path)


# (kernel, stride, padding, LFU, cin, ratio_gin, ratio_gout)
UNITS = [
    (1, 1, 0, True, 3, 0.0, 0.5),    # Y-Net's first spectral stage
    (1, 1, 0, True, 8, 0.5, 0.5),    # Y-Net's later stages
    (3, 1, 1, True, 16, 0.75, 0.75),  # EdgeAL's resnet blocks
    (3, 2, 1, True, 16, 0.75, 0.75),  # EdgeAL's downsamples
    (3, 1, 1, False, 16, 0.5, 0.5),
    (3, 2, 1, False, 16, 0.5, 0.5),
    (7, 1, 0, True, 1, 0.0, 0.75),   # EdgeAL's stem (input pre-padded)
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", UNITS, ids=lambda c: "k{}s{}p{}{}_in{}_{}_{}".format(
    c[0], c[1], c[2], "lfu" if c[3] else "nolfu", *c[4:]))
def test_ffc_bn_act(case, train):
    k, s, p, lfu, cin, r_in, r_out = case
    tm = ffc.FFC_BN_ACT(ffc.split_channels(cin, r_in), 16, k, r_out, s, p,
                        act="relu", enable_lfu=lfu, generator=_gen())
    got = _check_both(tm, case, train)
    assert tm.out_channels == tuple(0 if t is None else t.shape[1]
                                    for t in got)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_ffc_resnet_block(train):
    _check_both(ffc.FFCResnetBlock(16, 0.75, 0.75, generator=_gen()),
                "resnet", train)


@pytest.mark.parametrize("ratio", [0.5, 0.0])
def test_ffc_se_block(ratio):
    x = _stream(np.random.default_rng(2), ffc.split_channels(32, ratio))
    jm = jffc.FFCSEBlock(32, ratio)
    v = jax_variables(jm, x)
    tm = _port(ffc.FFCSEBlock(32, ratio, generator=_gen()), v)
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = tm(tuple(map(nchw, x)))
    _assert_stream(got, want)


def test_spatial_transform_wrapper():
    """The wrapper around an FFC_BN_ACT at a random angle; the angle
    carried as the layer map's ``angle`` kind."""
    split = ffc.split_channels(16, 0.5)
    x = _stream(np.random.default_rng(3), split)
    jm = jffc.LearnableSpatialTransformWrapper(
        jffc.FFC_BN_ACT(16, 3, 0.5, 0.5, padding=1, act="relu"))
    v = jax_variables(jm, x)
    assert tree_shapes(v["params"])["['angle']"] == (1,)
    v["params"]["angle"] = np.float32(
        np.random.default_rng(4).uniform(0, 360, (1,)))
    tm = _port(ffc.LearnableSpatialTransformWrapper(
        ffc.FFC_BN_ACT(split, 16, 3, 0.5, padding=1, act="relu",
                       generator=_gen()), generator=_gen()), v)
    assert tm.angle.item() == pytest.approx(float(v["params"]["angle"][0]))
    want = jax.jit(jm.apply)(v, x)
    with torch.no_grad():
        got = tm.eval()(tuple(map(nchw, x)))
    _assert_stream(got, want)
    back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
    assert tree_shapes(back) == tree_shapes(v)


def test_concat_stream():
    x = _stream(np.random.default_rng(5), (3, 5))
    got = ffc.concat_stream(tuple(map(nchw, x)))
    assert scale_rel(got, jffc.concat_stream(x)) == 0.0
    assert ffc.concat_stream((nchw(x[0]), None)) is not None


@pytest.mark.parametrize("k", [2, 3, 4])
def test_avg_pool(k):
    """Stride k, 'VALID': 17 x 12 leaves a remainder at k = 3 and 4."""
    x = np.random.default_rng(6).standard_normal((2, 17, 12, 3)).astype(
        np.float32)
    want = jpool.avg_pool(jnp.asarray(x), k)
    assert scale_rel(pooling.avg_pool(nchw(x), k), want) <= 1e-6


@pytest.mark.parametrize("k,stride", [(2, 1), (3, 2), (3, 1), (2, 3)])
def test_avg_pool_stride(k, stride):
    """JAX's ``stride`` != k: overlapping windows, and windows with gaps
    between them, 'VALID' at 17 x 12."""
    x = np.random.default_rng(9).standard_normal((2, 17, 12, 3)).astype(
        np.float32)
    want = jpool.avg_pool(jnp.asarray(x), k, stride)
    got = pooling.avg_pool(nchw(x), k, stride)
    assert scale_rel(got, want) <= 1e-6


@pytest.mark.parametrize("out_hw", [(1, 1), (4, 3), (5, 7)])
def test_adaptive_avg_pool(out_hw):
    x = np.random.default_rng(7).standard_normal((2, 16, 12, 3)).astype(
        np.float32)
    want = jpool.adaptive_avg_pool(jnp.asarray(x), out_hw)
    assert scale_rel(pooling.adaptive_avg_pool(nchw(x), out_hw),
                     want) <= 1e-6


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-1.6, 1.6), (-5.3, 4.7),
                                   (-1.0, -1.0)])
def test_grid_sample_bilinear(lo, hi):
    """Inside the image, reflected once, reflected several times, and on
    the edge (gx = gy = -1)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 13, 3)).astype(np.float32)
    grid = rng.uniform(lo, hi, (2, 7, 11, 2)).astype(np.float32)
    want = jsampling.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid))
    got = sampling.grid_sample_bilinear(nchw(x), torch.from_numpy(grid))
    assert scale_rel(got, want) <= 1e-6


@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-1.6, 1.6), (-5.3, 4.7)])
@pytest.mark.parametrize("align_corners", [True, False])
@pytest.mark.parametrize("padding_mode", ["reflection", "zeros"])
def test_grid_sample_bilinear_options(padding_mode, align_corners, lo, hi):
    """JAX's ``padding_mode`` and ``align_corners``, crossed: points
    inside the image, up to 0.6 outside it (partly within a pixel of the
    border, where "zeros" clamps the corners) and far outside."""
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 9, 13, 3)).astype(np.float32)
    grid = rng.uniform(lo, hi, (2, 7, 11, 2)).astype(np.float32)
    kw = {"padding_mode": padding_mode, "align_corners": align_corners}
    want = jsampling.grid_sample_bilinear(jnp.asarray(x), jnp.asarray(grid),
                                          **kw)
    got = sampling.grid_sample_bilinear(nchw(x), torch.from_numpy(grid), **kw)
    assert scale_rel(got, want) <= 1e-6


@pytest.mark.parametrize("angle", [37.3, -121.0, 0.0])
def test_reference_rotate(angle):
    """The transposed-meshgrid quirk on a non-square image (H != W reads
    the (W*H, 2) grid buffer as (H, W, 2))."""
    x = np.random.default_rng(9).standard_normal((2, 12, 20, 3)).astype(
        np.float32)
    want = jsampling.reference_rotate(jnp.asarray(x), jnp.float32(angle))
    got = sampling.reference_rotate(nchw(x), torch.tensor(angle))
    assert scale_rel(got, want) <= 1e-5


@pytest.mark.parametrize("name", sorted(blocks.ACTIVATIONS))
def test_activation(name):
    x = np.random.default_rng(10).standard_normal((64,)).astype(np.float32)
    want = np.asarray(jblocks.activation(name)(jnp.asarray(x)))
    got = blocks.activation(name)(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("k,s,p,op", [(3, 2, 1, 1), (4, 1, 0, 0),
                                      (4, 2, 1, 0), (2, 2, 0, 0)])
def test_conv_transpose(k, s, p, op):
    """``blocks.conv_transpose`` against the JAX ``ConvTranspose`` (input
    dilation, flipped kernel) given its (k, k, in, out) kernel."""
    x = np.random.default_rng(11).standard_normal((2, 5, 7, 6)).astype(
        np.float32)
    jm = jblocks.ConvTranspose(4, k, s, p, output_padding=op)
    v = jax_variables(jm, x)
    tm = torch.nn.ModuleDict(
        {"ct": blocks.conv_transpose(6, 4, k, s, p, op, generator=_gen())})
    tm.load_state_dict(state_dict_from_jax(v, [("ct", (), "ct")]))
    want = jm.apply(v, x)
    with torch.no_grad():
        got = tm["ct"](nchw(x))
    assert scale_rel(got, want) <= 1e-6
