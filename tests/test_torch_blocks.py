"""The port's generic blocks (``models/blocks.py``: ``PReLU``,
``ConvBNAct``, ``DoubleConv``, ``SqueezeExcitation``, ``AttentionGate``,
``ASPP``, ``SeparableConv``) and SD_Layer_Net's builders (``models/sdnet/
unet.py``: ``U_Net``, ``AttU_Net``, ``AttU_Net4``) against the JAX
package's, on the CPU: the JAX variables (drawn from a seed, BatchNorm
affines and statistics and biases random) carried in by
``utils/convert.layer_map``; eval and train outputs, the running
statistics after the train call, and the train-mode gradient of
sum(output * cotangent) over the parameters, each at 1e-4 of its largest
JAX value. JAX is jitted once a case.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    blocks as jb,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.models.sdnet import (
    unet as junet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    blocks as tb,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.sdnet import (
    unet as tunet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    layer_map,
    state_dict_from_jax,
    variables_from_state_dict,
)

from test_torch_common import nchw, scale_rel

N, HW, TOL = 4, 16, 1e-4
# name -> (JAX module, port module, input channels, train argument)
BLOCKS = {
    "PReLU": (lambda: jb.PReLU(), lambda: tb.PReLU(), (4,), False),
    "ConvBNAct": (lambda: jb.ConvBNAct(8), lambda: tb.ConvBNAct(4, 8),
                  (4,), True),
    "ConvBNAct_gelu_dilated_no_bn": (
        lambda: jb.ConvBNAct(6, 3, 1, 2, "gelu", use_bn=False,
                             kernel_dilation=2),
        lambda: tb.ConvBNAct(4, 6, 3, 1, 2, "gelu", use_bn=False,
                             kernel_dilation=2), (4,), True),
    "ConvBNAct_strided_grouped": (
        lambda: jb.ConvBNAct(8, 3, 2, 1, "leaky_relu",
                             feature_group_count=2),
        lambda: tb.ConvBNAct(4, 8, 3, 2, 1, "leaky_relu",
                             feature_group_count=2), (4,), True),
    "DoubleConv": (lambda: jb.DoubleConv(6, act="tanh"),
                   lambda: tb.DoubleConv(4, 6, act="tanh"), (4,), True),
    "SqueezeExcitation": (lambda: jb.SqueezeExcitation(ratio=2),
                          lambda: tb.SqueezeExcitation(8, 2), (8,), False),
    "AttentionGate": (lambda: jb.AttentionGate(3),
                      lambda: tb.AttentionGate(6, 4, 3), (6, 4), True),
    "ASPP": (lambda: jb.ASPP(6, dilations=(1, 2, 3)),
             lambda: tb.ASPP(4, 6, dilations=(1, 2, 3)), (4,), True),
    "SeparableConv": (lambda: jb.SeparableConv(6, strides=2, use_bias=True),
                      lambda: tb.SeparableConv(4, 6, strides=2,
                                               use_bias=True), (4,), False),
}


def _variables(jm, inputs, seed):
    """numpy variables of ``jm`` (``jax.eval_shape``, nothing compiled):
    kernels U(+-1/sqrt(fan_in)), BatchNorm affines and statistics, biases
    and the PReLU slope random."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *inputs))
    rng = np.random.default_rng(seed)
    draw = {"mean": lambda s: rng.normal(0, 0.1, s),
            "var": lambda s: rng.uniform(0.5, 1.5, s),
            "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0, 0.1, s),
            "alpha": lambda s: rng.uniform(0.1, 0.4, s),
            "kernel": lambda s: rng.uniform(-1, 1, s) / np.sqrt(
                np.prod(s[:-1]))}

    def walk(tree):
        return {k: walk(t) if isinstance(t, dict) else
                draw[k](t.shape).astype(np.float32) for k, t in tree.items()}

    return {k: walk(dict(v)) for k, v in shapes.items()}


def _jax_readings(jm, v, xs, cots, train_arg):
    """(eval output, train output, batch_stats after it, gradient of
    sum(train output * cot) over the params)."""
    stats = v.get("batch_stats", {})

    def run(params, train):
        kw = {"train": train} if train_arg else {}
        if not train or not stats:
            return jm.apply({"params": params, **({"batch_stats": stats}
                                                  if stats else {})},
                            *xs, **kw), stats
        return jm.apply({"params": params, "batch_stats": stats}, *xs,
                        mutable=["batch_stats"], **kw)

    def loss(params):
        out, mut = run(params, True)
        return jnp.sum(out * cots), (out, mut)

    @jax.jit
    def both(params):
        (_, (out, mut)), grads = jax.value_and_grad(loss, has_aux=True)(
            params)
        return run(params, False)[0], out, mut, grads

    ev, tr, mut, grads = both(v["params"])
    return ev, tr, (mut.get("batch_stats", {}) if mut else {}), grads


def _port(tm, v):
    tm.load_state_dict(state_dict_from_jax(v, layer_map(tm)))
    return tm


def _check(tm, v, xs, cots, want, train_arg):
    ev, tr, stats, grads = want
    tm = _port(tm, v)
    with torch.no_grad():
        assert scale_rel(tm.eval()(*map(nchw, xs)), ev) <= TOL
    tm.train()
    out = tm(*map(nchw, xs))
    assert scale_rel(out, tr) <= TOL
    torch.sum(out * nchw(cots)).backward()
    got = variables_from_state_dict(
        {**tm.state_dict(), **{n: p.grad for n, p in tm.named_parameters()}},
        layer_map(tm))
    if stats:
        want_stats = dict(jax.tree_util.tree_leaves_with_path(stats))
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                got["batch_stats"]):
            assert scale_rel(leaf, want_stats[path]) <= TOL, path
    want_g = dict(jax.tree_util.tree_leaves_with_path(grads))
    got_g = jax.tree_util.tree_leaves_with_path(got["params"])
    assert len(got_g) == len(want_g)
    top = max(float(np.abs(np.asarray(w)).max()) for w in want_g.values())
    for path, leaf in got_g:
        w = np.asarray(want_g[path])
        scale = float(np.abs(w).max())
        if scale < 1e-4 * top:
            # a conv bias before a train-mode BatchNorm: its gradient is 0
            # in exact arithmetic and both sides hold rounding, held to
            # TOL of the largest gradient entry (as check_zoo_gradient)
            assert path[-1].key == "bias", path
            scale = top
        assert float(np.abs(leaf - w).max()) <= TOL * scale, path


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_matches_jax(name):
    jm_fn, tm_fn, cins, train_arg = BLOCKS[name]
    rng = np.random.default_rng(len(name))
    xs = [rng.standard_normal((N, HW, HW, c)).astype(np.float32)
          for c in cins]
    jm = jm_fn()
    v = _variables(jm, [jnp.asarray(x) for x in xs], seed=len(name))
    out_shape = jax.eval_shape(lambda: jm.apply(v, *xs))
    cots = rng.standard_normal(out_shape.shape).astype(np.float32)
    want = _jax_readings(jm, v, [jnp.asarray(x) for x in xs],
                         jnp.asarray(cots), train_arg)
    _check(tm_fn(), v, xs, cots, want, train_arg)


def test_prelu_and_se_defaults():
    assert float(tb.PReLU().weight.detach()) == 0.25
    se = tb.SqueezeExcitation(16)
    assert se.fc1.out_features == 2 and se.fc1.bias is not None
    assert tb.SqueezeExcitation(4).fc1.out_features == 1
    sep = tb.SeparableConv(4, 8)
    assert sep.depthwise.bias is None and sep.depthwise.groups == 4
    assert len(tb.ASPP(4, 8).branches) == 4


BUILDERS = {"U_Net": (4, 8, 16, 32, 64), "AttU_Net": (4, 8, 16, 32, 64),
            "AttU_Net4": (4, 8, 16, 32)}


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_sdnet_unet_builders_match_jax(name):
    """Narrow channels, 3 classes, 32x32, batch 2: eval and train outputs
    and the running statistics at 1e-4; the JAX defaults' channels."""
    chans = BUILDERS[name]
    jm = getattr(junet, name)(3, chans)
    tm = getattr(tunet, name)(3, chans, seed=1)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 32, 32, 1)).astype(np.float32)
    v = _variables(jm, [jnp.asarray(x)], seed=9)

    @jax.jit
    def both(v, x):
        train, mut = jm.apply(v, x, train=True, mutable=["batch_stats"])
        return jm.apply(v, x), train, mut["batch_stats"]

    ev, tr, stats = both(v, jnp.asarray(x))
    tm = _port(tm, v)
    with torch.no_grad():
        assert scale_rel(tm(nchw(x)), ev) <= TOL
        assert scale_rel(tm.train()(nchw(x)), tr) <= TOL
    back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
    want_stats = dict(jax.tree_util.tree_leaves_with_path(stats))
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            back["batch_stats"]):
        assert scale_rel(leaf, want_stats[path]) <= TOL, path
    default = getattr(tunet, name)()
    jdefault = getattr(junet, name)()
    assert [b.init_conv.out_channels for b in default.enc] == \
        list(jdefault.channels)
    assert (default.att is not None) == jdefault.attention
    assert default.head.out_channels == jdefault.out_channels == 1
