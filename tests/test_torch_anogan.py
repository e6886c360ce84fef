"""The port's AnoGAN (``models/anogan.py``) and its adversarial trainer
(``training/adversarial.py``) against the JAX package on the same
numpy-seeded inputs and weights, carried by ``utils/convert.layer_map``:
both modes, ``encode`` and ``decode``, in eval and train mode at 1e-4
scale-relative; ``bce_with_logits``; one ``AnoGANTrainer`` step from the
same variables against JAX's jitted ``step``: losses, Adam's moments (the
gradients), parameters and running statistics."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    anogan as janogan,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    adversarial as jadv,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training.losses import (
    bce_with_logits as jbce,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    anogan,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    adversarial,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
    bce_with_logits,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    layer_map,
    state_dict_from_jax,
    variables_from_state_dict,
)
from test_torch_common import jax_variables, nchw, scale_rel, tree_shapes

HW, TOL = 64, 1e-4
KEYS = ("g_features", "fake_images", "d_features_real", "d_pred_real",
        "d_features_fake", "d_pred_fake")


def _images(seed=1, n=4):
    return np.random.default_rng(seed).uniform(0, 1, (n, HW, HW, 1)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax():
    """(input, variables, {(mode, train): output}, encode, decode of the
    encoding), one compile."""
    jm = janogan.AnoGAN()
    x = _images()
    v = jax_variables(jm, jnp.asarray(x))

    def run(v, x):
        out = {}
        for mode in ("train", "recon"):
            out[mode, False] = jm.apply(v, x, train=False, mode=mode)
            out[mode, True] = jm.apply(v, x, train=True, mode=mode,
                                       mutable=["batch_stats"])[0]
        z = jm.apply(v, x, method=jm.encode)
        return out, z, jm.apply(v, z, method=jm.decode)

    return (x, v) + tuple(jax.jit(run)(v, jnp.asarray(x)))


def _port(v):
    tm = anogan.AnoGAN(generator=torch.Generator())
    tm.load_state_dict(state_dict_from_jax(v, layer_map(tm)))
    return tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("mode", ["train", "recon"])
def test_anogan_forward(mode, train):
    x, v, outs, _, _ = _jax()
    tm = _port(v).train(train)
    with torch.no_grad():
        got = tm(nchw(x), mode=mode)
    want = outs[mode, train]
    if mode == "train":
        assert set(got) == set(KEYS) == set(want)
        for k in KEYS:
            assert scale_rel(got[k], want[k]) <= TOL, k
    else:
        assert scale_rel(got, want) <= TOL


def test_anogan_encode_decode():
    x, v, _, z, recon = _jax()
    tm = _port(v).eval()
    with torch.no_grad():
        got = tm.encode(nchw(x))
        assert scale_rel(got, z) <= TOL
        assert scale_rel(tm.decode(nchw(np.asarray(z))), recon) <= TOL


def test_bce_with_logits():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 4, (3, 5, 5, 1)).astype(np.float32)
    targets = (rng.uniform(size=logits.shape) < 0.5).astype(np.float32)
    want = float(jbce(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(bce_with_logits(torch.from_numpy(logits),
                                torch.from_numpy(targets)))
    assert got == pytest.approx(want, rel=1e-6)


def test_default_width_parameters():
    """AnoGAN's widths are fixed: the layer map's tree equals
    ``jax.eval_shape`` of the JAX init, and so does the count."""
    shapes = jax.eval_shape(janogan.AnoGAN().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, HW, HW, 1)))
    tm = anogan.build_anogan()
    back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
    assert tree_shapes(back) == tree_shapes(shapes)
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n


# -- the trainer ---------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _steps():
    """One JAX step, and from the same variables one port step
    (``make_train_step``) and its two halves run by hand with JAX's D,
    after its step, put in before the G step: (JAX (new variables, opt_g,
    opt_d, metrics), (trainer, state, metrics) of the step, (trainer,
    state) of the halves)."""
    x = _images(3)
    jt = jadv.AnoGANTrainer()
    v = jax_variables(jt.model, jnp.asarray(x))
    _, opt_g, opt_d = jt.init(jnp.asarray(x))
    new = jax.tree.map(np.asarray, jt.make_train_step()(
        v, opt_g, opt_d, jnp.asarray(x)))

    def port():
        tt = adversarial.AnoGANTrainer(device="cpu")
        tt.model.load_state_dict(state_dict_from_jax(v, layer_map(tt.model)))
        return tt, tt.init()

    tt, state = port()
    metrics = tt.make_train_step()(state, torch.from_numpy(x))
    th, halves = port()
    th.model.train()
    adversarial._apply(th.d_loss(nchw(x)), th.model.D, halves.opt_d)
    jax_d = state_dict_from_jax(new[0], layer_map(th.model))
    with torch.no_grad():
        for n, p in th.model.D.named_parameters():
            p.copy_(jax_d["D." + n])
    g_loss, _ = th.g_loss(nchw(x))
    adversarial._apply(g_loss, th.model.G, halves.opt_g)
    return new, (tt, state, metrics), (th, halves)


def test_trainer_step_losses():
    (_, _, _, want), (_, state, got), _ = _steps()
    assert state.step == 1
    for k in ("d_loss", "g_loss", "rec"):
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5), k


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _cosine(a, b):
    a, b = np.ravel(a), np.ravel(b)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _assert_step(net, tt, opt, new, opt_state, exact):
    """``net``'s Adam first moments ((1 - b1) times its gradient): with
    ``exact`` within 1e-4 of JAX's largest, else at cosine > 0.9999 over
    the network and over every tensor above a norm of 1e-3 of the largest.
    Its parameters within 1e-4 scale-relative of JAX's at every element
    whose gradient is larger than twice its tensor's largest gradient
    difference (Adam's first step moves an element by about lr times the
    gradient's sign, which a difference that size could flip; these are
    most of the elements), and everywhere within 2 lr."""
    module = getattr(tt.model, net)
    moments = {f"{net}.{n}": opt.state[p]["exp_avg"]
               for n, p in module.named_parameters()}
    lm = layer_map(tt.model)
    got_mu = _leaves(variables_from_state_dict(
        {**tt.model.state_dict(), **moments}, lm)["params"][net])
    mu = {k: np.asarray(v) for k, v in _leaves(opt_state[0].mu).items()}
    assert set(got_mu) == set(mu)
    top = max(np.abs(w).max() for w in mu.values())
    for path, w in mu.items():
        if exact:
            assert np.abs(got_mu[path] - w).max() <= TOL * top, path
        elif np.linalg.norm(w) > 1e-3 * top:
            assert _cosine(got_mu[path], w) > 0.9999, path
    assert _cosine(np.concatenate([np.ravel(got_mu[k]) for k in mu]),
                   np.concatenate([np.ravel(mu[k]) for k in mu])) > 0.9999
    got = _leaves(variables_from_state_dict(tt.model.state_dict(), lm)[
        "params"][net])
    lr = tt.learning_rate
    sure_share = []
    for path, w in _leaves(new["params"][net]).items():
        sure = np.abs(mu[path]) > 2 * np.abs(got_mu[path] - mu[path]).max()
        d = np.abs(got[path] - w)
        assert d.max() <= 2 * lr * (1 + 1e-3), path
        assert d[sure].max() <= TOL * np.abs(w).max(), path
        sure_share.append(sure.mean())
    assert min(sure_share) > 0.5


def test_trainer_d_step():
    """The step's D half: D's gradient of the D loss and D's parameters."""
    (new, _, opt_d, _), (tt, state, _), _ = _steps()
    _assert_step("D", tt, state.opt_d, new, opt_d, exact=True)


def test_trainer_g_step():
    """The step's G half, given JAX's D after its step (D's parameters
    after one Adam step differ where its gradient is at float32 noise, and
    G's gradient reads them): G's gradient of the G loss, G's parameters,
    and every running statistic (G's updated twice, D's four times). G's
    gradient is held by cosine: single elements of it, the largest at the
    decoder's first transposed conv, differ between the two float32
    computations by up to ~5e-3 of the largest element, each loss term
    alone (rec, adversarial, feature) included."""
    (new, opt_g, _, _), _, (tt, halves) = _steps()
    _assert_step("G", tt, halves.opt_g, new, opt_g, exact=False)
    got = _leaves(variables_from_state_dict(
        tt.model.state_dict(), layer_map(tt.model))["batch_stats"])
    want = _leaves(new["batch_stats"])
    assert set(got) == set(want)
    for path, w in want.items():
        assert scale_rel(got[path], w) <= TOL, path
