"""The port's EdgeAL (``models/edgeal.py``) against the JAX package's on the
same numpy-seeded inputs and weights, carried by
``utils/convert.layer_map``: ngf 16, one resnet block, two downsamplings,
in eval and train mode (batch statistics; running statistics after the
call) at 1e-4 scale-relative; the parameter tree at the default width."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    edgeal as jedgeal,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    edgeal,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    layer_map,
    state_dict_from_jax,
    variables_from_state_dict,
)
from test_torch_common import jax_variables, nchw, scale_rel, tree_shapes

NC, HW, TOL = 3, 32, 1e-4
SMALL = dict(ngf=16, n_blocks=1, n_downsampling=2)


@functools.lru_cache(maxsize=None)
def _jax():
    """(input, variables, eval output, train output, batch_stats after the
    train call), one compile."""
    jm = jedgeal.EdgeAL(num_classes=NC, **SMALL)
    x = np.random.default_rng(1).standard_normal((2, HW, HW, 1)).astype(
        np.float32)
    v = jax_variables(jm, jnp.asarray(x))

    def both(v, x):
        train, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return jm.apply(v, x, train=False), train, mut["batch_stats"]

    return (x, v) + tuple(jax.jit(both)(v, jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_edgeal_forward(train):
    x, v, want_eval, want_train, stats = _jax()
    tm = edgeal.EdgeAL(1, NC, generator=torch.Generator(), **SMALL)
    tm.load_state_dict(state_dict_from_jax(v, layer_map(tm)))
    with torch.no_grad():
        got = tm.train(train)(nchw(x))
    assert scale_rel(got, want_train if train else want_eval) <= TOL
    if train:
        back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
        want = dict(jax.tree_util.tree_leaves_with_path(stats))
        got = jax.tree_util.tree_leaves_with_path(back["batch_stats"])
        assert len(got) == len(want)
        for path, leaf in got:
            assert scale_rel(leaf, want[path]) <= TOL, path


def test_edgeal_channel_split():
    """ratio 0.75 truncates as JAX's int(features * ratio): ngf 16 splits
    the stem 4 local / 12 global, the downsamples 8 / 24 and 16 / 48."""
    tm = edgeal.EdgeAL(1, NC, generator=torch.Generator(), **SMALL)
    assert tm.stem.out_channels == (4, 12)
    assert [d.out_channels for d in tm.downs] == [(8, 24), (16, 48)]
    assert tm.blocks[0].out_channels == (16, 48)


def test_default_width_parameters():
    """The registry's EdgeAL at the JAX defaults (ngf 64, 9 blocks, 3
    downsamplings, ratios 0.75) on one-channel input: the layer map's tree
    equals ``jax.eval_shape`` of the JAX init, and so does the count."""
    shapes = jax.eval_shape(jedgeal.EdgeAL().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))
    tm = get_model("edgeal", in_channels=1)
    back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
    assert tree_shapes(back) == tree_shapes(shapes)
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n
