"""The port's SDNet (``models/sdnet``) and the ops it adds (bilinear
upsampling, the float max-pool) against the JAX package, on the CPU.

Weights go from the port to JAX through ``utils/convert`` (the port model
is seeded, its BatchNorm terms randomised so that a BN taken from the wrong
layer shows). The reparameterisation noise is numpy's: JAX's
``jax.random.normal`` is replaced for the apply (``fixed_normal``) and the
port is given the same ``eps``.

The hard anatomy is ``round`` of the clean masks and sigmoid surfaces, so a
value within float32 rounding of .5 may round the other way in the two
packages; the forward is therefore held stage by stage, each port stage
given JAX's hard anatomy, sample and reconstruction, and the whole forward
states the share of hard-anatomy values it lets differ.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.models.sdnet.layer_engine import (
    LayerEngine as JaxLayerEngine,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.models.sdnet.sdnet import (
    SDNet as JaxSDNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.models.sdnet.unet import (
    UNetBackbone as JaxBackbone,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.pooling import (
    max_pool as jax_max_pool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops.resize import (
    upsample as jax_upsample,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.sdnet import (
    LayerEngine,
    SDNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.sdnet.unet import (
    UNetBackbone,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.pooling import (
    max_pool,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.resize import (
    upsample_bilinear,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    backbone_layer_map,
    sdnet_state_dict_from_jax,
    sdnet_variables_from_state_dict,
    variables_from_state_dict,
)

CHANNELS = (4, 8, 16, 32, 64)
HW, BATCH = 32, 2


@contextlib.contextmanager
def fixed_normal(eps):
    """``jax.random.normal`` returns ``eps`` (the encoder's only draw)."""
    orig = jax.random.normal
    jax.random.normal = lambda key, shape, dtype=jnp.float32: eps
    try:
        yield
    finally:
        jax.random.normal = orig


def randomize_bn(model, seed=0):
    """Random BN affines and running statistics, in place."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, n)),
                             (m.bias, rng.normal(0, 0.1, n)),
                             (m.running_mean, rng.normal(0, 0.1, n)),
                             (m.running_var, rng.uniform(0.5, 1.5, n))):
                    t.copy_(torch.tensor(v, dtype=torch.float32))
    return model


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(
        0, 3, 1, 2)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, tol=1e-4):
    """Within ``tol`` of the largest |want| (the zoo's scale-relative
    regime)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-6), err


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [2, 3])
@pytest.mark.parametrize("hw", [(8, 8), (5, 7)])
def test_upsample_bilinear_matches_jax(scale, hw):
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(
        np.float32)
    want = jax_upsample(jnp.asarray(x), scale, "bilinear", align_corners=True)
    got = upsample_bilinear(nchw(x), scale)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)


def test_max_pool_matches_jax_with_its_gradient():
    """Values, and the gradient split evenly between tied maxima (relu
    zeros), as ``jnp.max``'s."""
    x = np.maximum(np.random.default_rng(1).standard_normal(
        (2, 8, 12, 3)), 0).astype(np.float32)
    g = np.random.default_rng(2).standard_normal((2, 4, 6, 3)).astype(
        np.float32)
    want, vjp = jax.vjp(lambda t: jax_max_pool(t, 2), jnp.asarray(x))
    xt = nchw(x).requires_grad_(True)
    got = max_pool(xt, 2)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-6)
    got.backward(nchw(g))
    np.testing.assert_allclose(nhwc(xt.grad), np.asarray(vjp(g)[0]),
                               atol=1e-6)


# ---------------------------------------------------------------------------
# LayerEngine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_classes", [4, 12])
def test_layer_engine_matches_jax(n_classes):
    """At the JAX parity test's tolerances: lsm and masks 1e-4, positions
    and the violation terms 1e-3 (n_classes 12: the 11-layer curvature
    table)."""
    x = np.random.default_rng(3).standard_normal(
        (2, n_classes - 1, 64, 48)).astype(np.float32) * 3
    lsm, pos, masks, losses = LayerEngine(n_classes)(torch.from_numpy(x))
    jl, jp, jm, jlosses = jax.jit(JaxLayerEngine(48, n_classes).__call__)(
        jnp.asarray(x.transpose(0, 2, 3, 1)))
    np.testing.assert_allclose(nhwc(lsm), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(nhwc(masks), np.asarray(jm), atol=1e-4)
    np.testing.assert_allclose(pos.numpy().transpose(0, 2, 1),
                               np.asarray(jp), atol=1e-3)
    assert set(losses) == set(jlosses)
    for k, v in losses.items():
        np.testing.assert_allclose(v.numpy().transpose(0, 2, 1),
                                   np.asarray(jlosses[k]), atol=1e-3,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# U-Net backbones
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("attention", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_unet_backbone_matches_jax(attention, train):
    chans = (4, 8, 16, 32)
    model = randomize_bn(UNetBackbone(
        1, 3, chans, attention, generator=torch.Generator().manual_seed(4)))
    model.train(train)
    v = variables_from_state_dict(model.state_dict(),
                                  backbone_layer_map(4, attention))
    x = np.random.default_rng(5).standard_normal((2, 32, 32, 1)).astype(
        np.float32)
    jm = JaxBackbone(3, chans, attention)
    if train:
        want, _ = jm.apply(v, jnp.asarray(x), True, mutable=["batch_stats"])
    else:
        want = jm.apply(v, jnp.asarray(x), False)
    close(nhwc(model(nchw(x))), want)


# ---------------------------------------------------------------------------
# SDNet
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sdnet_case():
    """The port SDNet at channels (4, 8, 16, 32, 64), 32x32, its JAX
    variables, an input, eps, and JAX's whole forward in eval and train
    mode (jitted once each)."""
    model = randomize_bn(SDNet(img_size=HW, channels=CHANNELS,
                               generator=torch.Generator().manual_seed(0)))
    state = {k: v.clone() for k, v in model.state_dict().items()}
    v = sdnet_variables_from_state_dict(state)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((BATCH, HW, HW, 1)).astype(np.float32)
    eps = rng.standard_normal((BATCH, 15)).astype(np.float32)
    jm = JaxSDNet(img_size=HW, channels=CHANNELS)

    def forward(variables, x, e, train):
        with fixed_normal(e):
            if train:
                return jm.apply(variables, x, True, mutable=["batch_stats"])
            return jm.apply(variables, x, False), None

    fwd = jax.jit(forward, static_argnums=3)
    outs = {train: fwd(v, jnp.asarray(x), jnp.asarray(eps), train)
            for train in (False, True)}
    return {"model": model, "state": state, "variables": v, "x": x,
            "eps": eps, "jax": jm, "out": outs}


def test_converter_covers_the_whole_flax_tree(sdnet_case):
    """The Flax tree of JAX's own init and the converter's tree have the
    same 324 leaves with the same shapes; JAX -> port -> JAX is exact, and
    the port model loads the converted state dict strictly."""
    jm, v = sdnet_case["jax"], sdnet_case["variables"]
    shapes = jax.eval_shape(
        jm.init, {"params": jax.random.PRNGKey(0),
                  "latent": jax.random.PRNGKey(1)},
        jnp.zeros((1, HW, HW, 1)))
    want = {jax.tree_util.keystr(k): leaf.shape
            for k, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(k): leaf.shape
           for k, leaf in jax.tree_util.tree_leaves_with_path(v)}
    assert got == want and len(got) == 324
    back = sdnet_variables_from_state_dict(sdnet_state_dict_from_jax(v))
    for k, leaf in jax.tree_util.tree_leaves_with_path(v):
        assert np.array_equal(
            dict(jax.tree_util.tree_leaves_with_path(back))[k], leaf), k
    model = SDNet(img_size=HW, channels=CHANNELS,
                  generator=torch.Generator().manual_seed(1))
    model.load_state_dict(sdnet_state_dict_from_jax(v))


@pytest.mark.parametrize("train", [False, True])
def test_sdnet_forward_stage_by_stage(sdnet_case, train):
    """Each stage against JAX's, given JAX's hard anatomy, sample and
    reconstruction: masks and maps within 1e-4 of their scale, positions
    and violation terms within 1e-3; in train mode the BatchNorms use the
    batch statistics."""
    model = sdnet_case["model"]
    model.load_state_dict(sdnet_case["state"])
    model.train(train)
    want, _ = sdnet_case["out"][train]
    x = nchw(sdnet_case["x"])
    ha = nchw(want["hard_anatomy"])
    with torch.no_grad():
        prob_map, pos, masks, hard, losses = \
            model.get_layer_anatomical_factors(x)
        z_mean, z_logvar, sampled = model.get_modalities(
            x, ha, eps=torch.from_numpy(sdnet_case["eps"]))
        recon = model.get_reconstructed_img(
            ha, torch.from_numpy(np.array(want["sampled_z"])))
        z_est = model.get_z_estimate(nchw(want["reconstruction"]), ha)
    close(nhwc(prob_map), want["prob_map"])
    close(nhwc(masks), want["clean_masks"])
    np.testing.assert_allclose(pos.numpy().transpose(0, 2, 1),
                               np.asarray(want["layer_positions"]),
                               atol=1e-3)
    for k, t in losses.items():
        np.testing.assert_allclose(t.numpy().transpose(0, 2, 1),
                                   np.asarray(want["extra_losses"][k]),
                                   atol=1e-3, err_msg=k)
    # at this seed no value sits within rounding of a .5 tie
    assert np.array_equal(nhwc(hard), np.asarray(want["hard_anatomy"]))
    for got, key in ((z_mean, "z_mean"), (z_logvar, "z_logvar"),
                     (sampled, "sampled_z"), (z_est, "z_estimate")):
        close(got.numpy(), want[key])
    close(nhwc(recon), want["reconstruction"])


def test_sdnet_whole_forward(sdnet_case):
    """The whole eval-mode forward: at most 0.1% of the hard-anatomy values
    may round the other way (none do at this seed); the outputs then agree
    as the stages do."""
    model = sdnet_case["model"]
    model.load_state_dict(sdnet_case["state"])
    model.eval()
    want, _ = sdnet_case["out"][False]
    with torch.no_grad():
        out = model(nchw(sdnet_case["x"]),
                    eps=torch.from_numpy(sdnet_case["eps"]))
    differ = np.mean(nhwc(out["hard_anatomy"])
                     != np.asarray(want["hard_anatomy"]))
    assert differ <= 1e-3
    assert set(out) == set(want)
    for key in ("clean_masks", "reconstruction"):
        close(nhwc(out[key]), want[key])
    for key in ("z_mean", "z_logvar", "sampled_z", "z_estimate"):
        close(out[key].numpy(), want[key])


def test_sdnet_without_surface_predictor():
    """n_anatomical_factors == n_classes: no surface head, the anatomy is
    the clean masks; the converter maps the smaller tree both ways."""
    model = SDNet(img_size=16, n_classes=4, n_anatomical_factors=4,
                  channels=(4, 8), generator=torch.Generator().manual_seed(7))
    assert model.surface_predictor is None
    v = sdnet_variables_from_state_dict(model.state_dict())
    assert "surface_predictor" not in v["params"]
    model.load_state_dict(sdnet_state_dict_from_jax(v))
    out = model.eval()(torch.zeros(1, 1, 16, 16),
                       eps=torch.zeros(1, 15))
    assert out["hard_anatomy"].shape == (1, 4, 16, 16)


# ---------------------------------------------------------------------------
# cli smoke
# ---------------------------------------------------------------------------


def _smoke(capsys, model):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        cli,
    )

    cli.main(["smoke", "--model", model, "--num-classes", "4",
              "--device", "cpu"])
    return capsys.readouterr().out.splitlines()


def test_cli_smoke_sdnet(capsys):
    """``cli smoke --model sdnet`` builds SDNet as the JAX CLI does (64x64,
    channels (8, 16, 32, 64, 128)); its parameter count is the JAX
    model's."""
    (line,) = _smoke(capsys, "sdnet")
    assert line.startswith("sdnet") and " ok " in line
    shapes = jax.eval_shape(
        JaxSDNet(n_classes=4, img_size=64, channels=(8, 16, 32, 64, 128)).init,
        {"params": jax.random.PRNGKey(0), "latent": jax.random.PRNGKey(1)},
        jnp.zeros((1, 64, 64, 1)))
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert f"params={n:>12,}" in line
    assert "'prob_map': (1, 3, 64, 64)" in line


def test_cli_smoke_all_and_unknown(capsys):
    """``smoke --model all`` prints an ok line for each of the 18 names;
    an unknown name prints its FAIL line (the JAX CLI's reporting) and
    raises under ``--strict``."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        cli,
    )

    lines = _smoke(capsys, "all")
    assert [ln.split()[0] for ln in lines] == [
        "anogan", "bionet", "edgeal", "fouriernet", "islam", "lightreseg",
        "m2snet", "masood", "mgunet", "mgunet_2", "msnet", "relaynet",
        "retifluidnet", "sdnet", "unet", "watnet", "y_net_gen",
        "y_net_gen_ffc"]
    assert all(" ok " in ln for ln in lines)
    (line,) = _smoke(capsys, "no_such_model")
    assert line.split()[:3] == ["no_such_model", "FAIL:", "ValueError:"]
    assert "Available: anogan" in line
    with pytest.raises(ValueError, match="Unknown model 'no_such_model'"):
        cli.main(["smoke", "--model", "no_such_model", "--device", "cpu",
                  "--strict"])
