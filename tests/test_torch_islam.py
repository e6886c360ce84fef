"""The port's ISLAM (``models/islam.py``) against the JAX package's on the
same numpy-seeded inputs and weights, carried by
``utils/convert.layer_map``, at 32x32, batch 4: the single head, the three
heads, the three heads with the Gaussian log-variance heads (both outputs;
the log-variances are ReLUs, so >= 0), GroupNorm in the head ASPP, and no
input InstanceNorm, in eval and train mode at 1e-4 scale-relative with the
running statistics after the train call; the 65,421,483-parameter tree at
the default width. At 32x32 the bottleneck ASPP(1024) sees a 1x1 map (its
centre taps only); the head ASPP(27, groups 3) runs at full resolution,
where its dilations act. The batch is 4 because the BatchNorms of a 1x1
map see one value an image: over 2 values the variance is one squared
difference, which E[x^2] - mean^2 in float32 gets from sums rounded
differently in JAX (float32 sums) and here (float64 sums, rounded), so the
train outputs part beyond the tolerance at batch 2."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    islam as jislam,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    islam,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from test_torch_common import (
    check_zoo_forward,
    default_tree_matches,
    jax_eval_train,
    jax_variables,
    nchw,
    normal_images,
)

NC, HW, BATCH, TOL = 3, 32, 4, 1e-4
CASES = {
    "single": (),
    "multi": (("use_multi_head", True),),
    "multi-gaussian": (("use_multi_head", True), ("gaussian_output", True)),
    "groupnorm": (("group_norm", True),),
    "no-instancenorm": (("use_input_instance_norm", False),),
}


@functools.lru_cache(maxsize=None)
def _jax_run(flags):
    """(input, variables, eval output, train output, batch_stats) of the
    JAX ISLAM built with ``flags``."""
    jm = jislam.ISLAM(num_classes=NC, **dict(flags))
    x = normal_images(1, BATCH, HW)
    v = jax_variables(jm, x)
    return (x, v) + tuple(jax_eval_train(jm, x, v))


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(input, variables, eval output, train output, batch_stats) of the
    JAX ISLAM of ``case``. Two cases reuse another's compile: the three
    heads are the first output of the model with the Gaussian heads too
    (the same modules, the extra heads' variables dropped), and the
    default model is the one without the input InstanceNorm applied to
    ``instance_norm(x)``, as its ``__call__`` reads."""
    if case == "multi":
        x, v, ev, tr, st = _jax_run(CASES["multi-gaussian"])
        extra = {f"CustomHead_{i}" for i in (3, 4, 5)}
        v = {c: {k: t for k, t in tree.items() if k not in extra}
             for c, tree in v.items()}
        st = {k: t for k, t in st.items() if k not in extra}
        return x, v, ev[0], tr[0], st
    if case == "single":
        x, v, _, _, _ = _jax_run(CASES["no-instancenorm"])
        jm = jislam.ISLAM(num_classes=NC, use_input_instance_norm=False)
        z = np.asarray(jislam.instance_norm(jnp.asarray(x)))
        return (x, v) + tuple(jax_eval_train(jm, z, v))
    return _jax_run(CASES[case])


@functools.lru_cache(maxsize=None)
def _port(case):
    """The port's module of ``case``, built once (``check_zoo_forward``
    loads every weight and statistic anew)."""
    return islam.ISLAM(1, NC, generator=torch.Generator(),
                       **dict(CASES[case]))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", list(CASES))
def test_islam_forward(case, train):
    x, v, want_eval, want_train, stats = _jax_case(case)
    got = check_zoo_forward(_port(case), v, x, want_train if train else want_eval,
                            stats, train, TOL)
    if case == "multi-gaussian":
        assert [tuple(t.shape) for t in got] == [(BATCH, 3, HW, HW)] * 2
        assert float(got[1].min()) >= 0.0


def test_instance_norm_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 9, 7, 3)).astype(
        np.float32) * 3 + 1
    want = np.asarray(jislam.instance_norm(jnp.asarray(x)))
    got = islam.instance_norm(nchw(x)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_default_width_parameters():
    """The registry's ISLAM at the JAX defaults (single head, 3 classes):
    the layer map's tree equals ``jax.eval_shape`` of the JAX init, leaf
    for leaf, 65,421,483 parameters."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    n = default_tree_matches(jax_get_model("islam"), get_model("islam"), 64)
    assert n == 65_421_483
