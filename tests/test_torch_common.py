"""Helpers shared by the PyTorch port's tests, and tests of its small modules
(registry, config, preprocessing) against the JAX package.

Inputs come from numpy generators and cross between the two frameworks as
numpy arrays; JAX runs on the CPU (tests/conftest.py).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.models.unet import (
    UNet as JaxUNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.preprocess import (
    zscore as jax_zscore,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
    DataConfig,
    ModelConfig,
    get_model,
    list_models,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
    preprocess,
    zscore,
)

# The tier-1 command runs six pytest workers on the host's cores, and
# torch's default intra-op pool (a thread per core in every worker)
# oversubscribes them: the same 69 tests of six of the heaviest port files
# under six workers took 1167 test-seconds at the default against 261 at
# two threads a worker, on an 8-core host. Every worker imports this
# module when it collects the port's tests, so the cap holds for the
# whole run.
TORCH_THREADS = 2
torch.set_num_threads(min(torch.get_num_threads(), TORCH_THREADS))


def randomize_unet_variables(variables, seed=0, gain=2.0):
    """U-Net weights with random BN affines and statistics (the README's
    parity regime), so that a wrong BN fold shows. The 3x3 kernels are
    scaled by ``gain`` from the torch-default init (sqrt(6) would be He
    variance), so activations do not vanish and the labels are not one
    class, while the argmax stays far enough from ties for the int8
    contracts."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            v = np.asarray(v)
            bn = any("BatchNorm" in p for p in path)
            if k == "kernel" and v.ndim == 4 and v.shape[0] == 3:
                v = v * gain
            elif k == "mean":
                v = rng.normal(0, 0.1, v.shape)
            elif k == "var":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "scale":
                v = rng.uniform(0.5, 1.5, v.shape)
            elif k == "bias" and bn:
                v = rng.normal(0, 0.1, v.shape)
            out[k] = v.astype(np.float32)
        return out

    return {"params": walk(variables["params"]),
            "batch_stats": walk(variables["batch_stats"])}


def jax_unet(f, nc=10, hw=64, seed=0, randomize=True):
    """(JAX UNet module, variables as numpy dicts): initialised from
    ``seed``, then randomized by ``randomize_unet_variables`` unless
    ``randomize`` is false."""
    model = JaxUNet(out_channels=nc, init_features=f)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 1)))
    if randomize:
        return model, randomize_unet_variables(v, seed)
    return model, jax.tree.map(np.asarray, v)


def jax_relaynet(f, nc=4, hw=64, seed=0, randomize=True):
    """(JAX ReLayNet module, variables as numpy dicts): initialised from
    ``seed``; unless ``randomize`` is false, with random BN affines and
    statistics, conv biases and PReLU slopes, so that a wrong fold or a
    slope taken from the wrong block shows."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.models.relaynet import (
        ReLayNet,
    )

    model = ReLayNet(num_classes=nc, num_filters=f)
    v = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 1)),
                   train=False)
    rng = np.random.default_rng(seed)
    draw = {"mean": lambda s: rng.normal(0, 0.1, s),
            "var": lambda s: rng.uniform(0.5, 1.5, s),
            "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0, 0.1, s),
            "alpha": lambda s: rng.uniform(0.05, 0.5, s)}

    def walk(tree):
        # keeps the dicts' call order, which the JAX package's
        # import_torch_state zips against (jax.tree.map would sort keys)
        return {k: walk(t) if isinstance(t, dict) else np.asarray(
                    draw[k](t.shape) if randomize and k in draw else t,
                    np.float32)
                for k, t in tree.items()}

    return model, {"params": walk(v["params"]),
                   "batch_stats": walk(v["batch_stats"])}


def rand_int8(rng, shape, lo=-100, hi=100):
    return rng.integers(lo, hi, shape).astype(np.int8)


def normal_images(seed, n, hw):
    return np.random.default_rng(seed).standard_normal(
        (n, hw, hw, 1)
    ).astype(np.float32)


def agreement(a, b):
    return float((np.asarray(a, np.int64) == np.asarray(b, np.int64)).mean())


def psrp_reference_case(f, nc=10, hw=64, deep_int4=False):
    """The JAX side of the whole-graph comparisons, computed once per module.

    * ``qparams``/``psrp``: PSRP qparams of the randomized U-Net (in the
      ``deep_int4`` mode) and the labels of the JAX PSRP graph (Pallas in
      interpret mode on the CPU).
    * ``variables``/``int8``/``float``: the regime of the JAX graph's own
      contract test (tests/test_psrp_forward.py): the U-Net as initialised,
      and the labels of the all-int8 and float graphs. Under the randomized
      weights the argmax sits so close to ties that even the JAX PSRP graph
      misses its own 0.995 contract against the int8 graph (98.2% at f=32),
      and a 1e-5 change of a calibrated scale moves ~4% of the labels.
    """
    from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
        psrp as jpsrp,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
        quantized as jq,
    )

    x = normal_images(1, 2, hw)
    xj = jnp.asarray(x)
    calib = [normal_images(0, 2, hw)]
    _, vr = jax_unet(f, nc, hw)
    layers = jq.fold_unet_bn(vr)
    qp = jax.tree.map(jnp.asarray, jpsrp.quantize_unet_psrp(
        layers, jq.calibrate_unet(layers, calib), init_features=f,
        deep_int4=deep_int4))
    _, v = jax_unet(f, nc, hw, randomize=False)
    layers = jq.fold_unet_bn(v)
    q8 = jq.quantize_unet(layers, jq.calibrate_unet(layers, calib),
                          pallas=False)
    return {
        "f": f, "nc": nc, "x": x, "qparams": qp, "variables": v,
        "deep_int4": deep_int4,
        "psrp": np.asarray(jpsrp.unet_psrp_forward(qp, xj, nc, tg=4)),
        "int8": np.asarray(jnp.argmax(jq.unet_int8_forward(q8, xj), -1)),
        "float": np.asarray(jnp.argmax(jq.folded_forward(layers, xj), -1)),
    }


def port_psrp_labels_given_jax_qparams(case, **kw):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        attach_kernel_params,
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_qparams_from_jax,
    )

    qp = attach_kernel_params(unet_qparams_from_jax(case["qparams"]))
    return unet_psrp_forward(qp, torch.from_numpy(case["x"]), case["nc"],
                             **kw)


def port_psrp_labels_full_pipeline(case):
    """The port's own fold, calibration and quantization of the same
    weights, then its served graph."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
        quantized as tq,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        quantize_unet_psrp,
        unet_psrp_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
        UNet,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_state_dict_from_jax,
    )

    model = UNet(1, case["nc"], case["f"])
    model.load_state_dict(unet_state_dict_from_jax(case["variables"]))
    layers = tq.fold_unet_bn(model)
    taps = tq.calibrate_unet(layers, [normal_images(0, 2, case["x"].shape[1])])
    qp = quantize_unet_psrp(layers, taps, init_features=case["f"],
                            deep_int4=case["deep_int4"])
    return unet_psrp_forward(qp, torch.from_numpy(case["x"]), case["nc"])


def test_registry():
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
        list_models as jax_list_models,
    )

    assert list_models() == jax_list_models() == [
        "anogan", "bionet", "edgeal", "fouriernet", "islam", "lightreseg",
        "m2snet", "masood", "mgunet", "mgunet_2", "msnet", "relaynet",
        "retifluidnet", "sdnet", "unet", "watnet", "y_net_gen",
        "y_net_gen_ffc"]
    m = get_model("unet", num_classes=4, init_features=4)
    assert m.conv.out_channels == 4
    m = get_model("relaynet", num_classes=4, num_filters=8)
    assert m.classifier.out_channels == 4
    assert m.encode1.conv.kernel_size == (7, 3)
    m = get_model("sdnet", num_classes=5, img_size=32, channels=(4, 8))
    assert m.layer_predictor.head.out_channels == 4
    assert m.surface_predictor.head.out_channels == 12 - 5
    m = get_model("y_net_gen_ffc", num_classes=4, init_features=8)
    assert m.conv.out_channels == 4 and m.ffc
    m = get_model("edgeal", in_channels=1, num_classes=3, ngf=8,
                  n_blocks=1, n_downsampling=2)
    assert m.head.out_channels == 3
    m = get_model("mgunet_2", num_classes=4, feature_scale=8)
    assert m.pools == (2, 2, 2) and m.head.out_channels == 4
    m = get_model("m2snet", in_channels=1, num_classes=4)
    assert m.multi_kernel and m.head.out_channels == 4
    # an unknown name raises ValueError listing the names, as in JAX
    for get in (get_model, jax_get_model):
        with pytest.raises(ValueError, match="Available: anogan, bionet"):
            get("no_such_model")


def test_config_defaults_match_jax():
    from retinal_oct_image_segmentation_via_deep_learning_tpu import config

    for ours, theirs in ((ModelConfig(), config.ModelConfig()),
                         (DataConfig(), config.DataConfig())):
        for field, value in vars(ours).items():
            assert getattr(theirs, field) == value, field


def test_zscore_matches_jax():
    x = np.random.default_rng(0).uniform(0, 255, (2, 16, 24, 1))
    x = x.astype(np.float32)
    want = np.asarray(jax_zscore(jnp.asarray(x)))
    got = zscore(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(preprocess(torch.from_numpy(x)).numpy(),
                                  got)
    # flattening is ported: JAX's pipeline within 1e-5
    from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.preprocess import (
        preprocess as jax_preprocess,
    )

    np.testing.assert_allclose(
        preprocess(torch.from_numpy(x), flatten=True).numpy(),
        np.asarray(jax_preprocess(jnp.asarray(x), flatten=True)),
        rtol=1e-5, atol=1e-5)


# -- the zoo models (test_torch_ffc, _ynet, _edgeal, _anogan, _fouriernet) --


def jax_variables(module, *inputs, seed=0, bias_std=0.1, conv_bias_std=None,
                  **kw):
    """numpy variables in the tree of ``module.init(key, *inputs, **kw)``
    (read by ``jax.eval_shape``, nothing compiled), drawn from ``seed``:
    kernels U(+-1/sqrt(fan_in)) as torch draws them, BatchNorm affines and
    statistics and biases random, so that a statistic, an affine or a bias
    carried to the wrong layer shows; ``angle`` U(0, 80); the channel
    attentions' ``gamma`` U(0.5, 1) (zero at init, which would hide them);
    ``cls_token`` and ``pos_embedding`` N(0, 1); biases N(0,
    ``bias_std``^2), those of a flax ``Conv`` N(0, ``conv_bias_std``^2)
    where it is given."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0),
                                                *inputs, **kw))
    rng = np.random.default_rng(seed)
    draw = {"mean": lambda s: rng.normal(0, 0.1, s),
            "var": lambda s: rng.uniform(0.5, 1.5, s),
            "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0, bias_std, s),
            "angle": lambda s: rng.uniform(0, 80, s),
            "gamma": lambda s: rng.uniform(0.5, 1.0, s),
            "cls_token": lambda s: rng.normal(0, 1, s),
            "pos_embedding": lambda s: rng.normal(0, 1, s),
            "kernel": lambda s: rng.uniform(-1, 1, s) / np.sqrt(
                np.prod(s[:-1]))}

    if conv_bias_std is not None:
        draw["conv_bias"] = lambda s: rng.normal(0, conv_bias_std, s)

    def walk(tree, parent=""):
        return {k: walk(t, k) if isinstance(t, dict) else
                draw["conv_bias" if k == "bias" and parent.startswith("Conv")
                     and "conv_bias" in draw else k](t.shape).astype(
                         np.float32)
                for k, t in tree.items()}

    return {k: walk(dict(v)) for k, v in shapes.items()}


def nchw(x):
    """An NHWC numpy array (or None) as an NCHW torch tensor."""
    return None if x is None else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def scale_rel(got, want):
    """max |got - want| / max |want|; ``got`` an NCHW torch tensor (or any
    array) held to ``want``, its NHWC counterpart."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else \
        np.asarray(got)
    want = np.asarray(want)
    if got.ndim == 4:
        got = got.transpose(0, 2, 3, 1)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def tree_shapes(tree):
    """{path: shape} of a variable tree (numpy or ``jax.eval_shape``)."""
    return {jax.tree_util.keystr(k): tuple(leaf.shape) for k, leaf in
            jax.tree_util.tree_leaves_with_path(tree)}


@functools.lru_cache(maxsize=None)
def _eval_train_fn(jm, grad):
    """The jitted ``jax_eval_train`` of the JAX module ``jm``, kept so that
    a second input of the same shape reuses its compile."""

    def both(v, x, cot):
        def loss(params):
            out, mut = jm.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            if not grad:
                return 0.0, (out, mut)
            return sum(jnp.sum(o * c) for o, c in zip(
                jax.tree.leaves(out), jax.tree.leaves(cot))), (out, mut)

        if grad:
            (_, (train, mut)), grads = jax.value_and_grad(
                loss, has_aux=True)(v["params"])
        else:
            _, (train, mut) = loss(v["params"])
        out = (jm.apply(v, x, train=False), train, mut["batch_stats"])
        return out + ((grads,) if grad else ())

    return jax.jit(both)


def jax_eval_train(jm, x, v, cot=None):
    """(eval output, train output, batch_stats after the train call[,
    gradient of sum(train output * cot) over the params]) of the JAX
    module ``jm`` on the NHWC input ``x``, one compile per module; for a
    tuple of outputs ``cot`` is a tuple, one cotangent each."""
    return _eval_train_fn(jm, cot is not None)(v, jnp.asarray(x), cot)


def load_jax(tm, v, lmap=None):
    """The port module ``tm`` with the JAX variables ``v`` loaded through
    ``lmap``, by default ``utils/convert.layer_map``'s."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        layer_map,
        state_dict_from_jax,
    )

    tm.load_state_dict(state_dict_from_jax(v, lmap or layer_map(tm)))
    return tm


def check_zoo_forward(tm, v, x, want, stats, train, tol=1e-4):
    """Load ``v`` into the port module ``tm`` through ``layer_map``, run
    it on ``x`` (NHWC numpy) in eval or train mode, and hold each output
    to ``want`` (an NHWC array or a tuple of them) at ``tol``
    scale-relative; after a train call, its running statistics too."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        layer_map,
        variables_from_state_dict,
    )

    with torch.no_grad():
        got = load_jax(tm, v).train(train)(nchw(x))
    got = tuple(got) if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert scale_rel(g, w) <= tol
    if train:
        back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
        want_stats = dict(jax.tree_util.tree_leaves_with_path(stats))
        got_stats = jax.tree_util.tree_leaves_with_path(back["batch_stats"])
        assert len(got_stats) == len(want_stats)
        for path, leaf in got_stats:
            assert scale_rel(leaf, want_stats[path]) <= tol, path
    return got


def default_tree_matches(jm, tm, hw):
    """The port module ``tm``'s layer-map tree equals ``jax.eval_shape``
    of the JAX module ``jm``'s init on a (1, hw, hw, 1) input, leaf for
    leaf, and the tree carried back gives the state dict again; -> the
    parameter count, which must also agree."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        layer_map,
        state_dict_from_jax,
        variables_from_state_dict,
    )

    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, hw, hw, 1)))
    sd = tm.state_dict()
    back = variables_from_state_dict(sd, layer_map(tm))
    assert tree_shapes(back) == tree_shapes(shapes)
    again = state_dict_from_jax(back, layer_map(tm))
    assert sorted(again) == sorted(sd)
    assert all(torch.equal(again[k], sd[k]) for k in sd)
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n
    return n


def check_zoo_gradient(tm, v, x, cot, grads, tol=1e-4, lmap=None):
    """The train-mode gradient of sum(output * cot) of the port module
    ``tm`` (JAX's variables ``v`` loaded), held to ``grads`` (``jax.grad``
    of the JAX twin) tensor by tensor at ``tol`` of the tensor's largest
    JAX entry. The biases of convs whose output meets a train-mode
    BatchNorm before any nonlinearity have a gradient of zero in exact
    arithmetic (the batch mean takes their constant out), so both sides
    hold rounding there: a tensor below 1e-4 of the largest gradient
    entry of all must be such a bias, held to ``tol`` of that entry (a
    parameter off the path has a gradient of exactly 0 on both sides). ->
    the number of such biases. ``lmap``: as ``load_jax``'s."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        layer_map,
        variables_from_state_dict,
    )

    lmap = lmap or layer_map(tm)
    tm = load_jax(tm, v, lmap).train()
    out = tm(nchw(x))
    out = out if isinstance(out, tuple) else (out,)
    cot = cot if isinstance(cot, tuple) else (cot,)
    sum(torch.sum(o * (nchw(c) if o.ndim == 4 else torch.from_numpy(c)))
        for o, c in zip(out, cot)).backward()
    g = {n: torch.zeros_like(p) if p.grad is None else p.grad
         for n, p in tm.named_parameters()}
    got = variables_from_state_dict({**tm.state_dict(), **g},
                                    lmap)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(grads))
    assert len(want) == len(jax.tree_util.tree_leaves(got))
    top = max(float(np.abs(np.asarray(w)).max()) for w in want.values())
    zero = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        w = np.asarray(want[path])
        err = float(np.abs(leaf - w).max())
        scale = float(np.abs(w).max())
        if scale == 0 and err == 0:  # a parameter off the path: both 0
            continue
        if scale < 1e-4 * top:
            zero += 1
            assert path[-1].key == "bias", jax.tree_util.keystr(path)
            assert err <= tol * top, jax.tree_util.keystr(path)
        else:
            assert err <= tol * scale, (jax.tree_util.keystr(path),
                                        err / scale)
    return zero
