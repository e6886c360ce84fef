"""The port's FourierNet (``models/fouriernet.py``), its FD targets
(``ops/fd.py``) and its pipeline (``training/fouriernet_pipeline.py``)
against the JAX package on the same numpy-seeded inputs and weights,
carried by ``utils/convert.layer_map``: the forward in eval mode and in
train mode at dropout 0 at 1e-4 scale-relative; ``fd_maps``,
``fourier_coefficients``, both contour finders and ``prepare_dataset`` as
equal arrays; the loss and one Adadelta step against JAX's ``_loss`` and
optax; the parameter tree at the default width; a short ``fit`` and
``predict`` on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    fouriernet as jfn,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import fd as jfd
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    fouriernet_pipeline as jpipe,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    fouriernet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import fd
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    fouriernet_pipeline as pipe,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    layer_map,
    state_dict_from_jax,
    variables_from_state_dict,
)
from test_torch_common import jax_variables, nchw, scale_rel, tree_shapes

HW, TOL = 32, 1e-4
FEATURES = (8, 16, 16, 32, 32)


def _masks(n=3, hw=HW, seed=0):
    """Binary masks: an ellipse with a hole, a bar, a dot, shifted per
    mask."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw, :hw]
    out = []
    for i in range(n):
        cy, cx = rng.uniform(0.35, 0.65, 2) * hw
        r = ((yy - cy) / (0.3 * hw)) ** 2 + ((xx - cx) / (0.2 * hw)) ** 2
        m = (r < 1) & ~(r < 0.15)
        m |= (yy > hw - 6) & (xx > 3 + i) & (xx < hw - 4)
        m[2, 2 + i] = True
        out.append(m.astype(np.uint8))
    return np.stack(out)


def _images(n=3, seed=1):
    return np.random.default_rng(seed).uniform(0, 255, (n, HW, HW)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax(fd_channel=2):
    """(input, variables, eval output, train output at dropout 0), one
    compile."""
    jm = jfn.FourierNet(fd_channel=fd_channel, features=FEATURES,
                        dropout=0.0)
    x = np.random.default_rng(2).standard_normal((2, HW, HW, 1)).astype(
        np.float32)
    v = jax_variables(jm, jnp.asarray(x))

    def both(v, x):
        return (jm.apply(v, x, train=False),
                jm.apply(v, x, train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)}))

    return (x, v) + tuple(jax.jit(both)(v, jnp.asarray(x)))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fouriernet_forward(train):
    x, v, want_eval, want_train = _jax()
    tm = fouriernet.FourierNet(1, 2, FEATURES, 0.0,
                               generator=torch.Generator())
    tm.load_state_dict(state_dict_from_jax(v, layer_map(tm)))
    with torch.no_grad():
        fd_maps, final = tm.train(train)(nchw(x))
    want_fd, want_final = want_train if train else want_eval
    assert len(fd_maps) == len(want_fd) == 2
    for got, want in zip(fd_maps, want_fd):
        assert scale_rel(got, want) <= TOL
    assert scale_rel(final, want_final) <= TOL


def test_dropout_needs_generator():
    """Train-mode dropout draws from the caller's generator, kept values
    scaled by 1 / (1 - rate), as flax's."""
    tm = fouriernet.FourierNet(1, 1, FEATURES, 0.5,
                               generator=torch.Generator()).train()
    x = torch.ones((1, 1, HW, HW))
    with pytest.raises(ValueError, match="Generator"):
        tm(x)
    y = fouriernet.dropout(torch.ones(1000), 0.5, True,
                           torch.Generator().manual_seed(0))
    assert set(y.unique().tolist()) == {0.0, 2.0}
    runs = [tm(x, torch.Generator().manual_seed(3))[1] for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


def test_default_width_parameters():
    """The registry's FourierNet at the JAX defaults (features 16-256, one
    FD channel, 2 classes): the layer map's tree equals ``jax.eval_shape``
    of the JAX init, and so does the count."""
    shapes = jax.eval_shape(jfn.FourierNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))
    tm = fouriernet.build_fouriernet()
    back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
    assert tree_shapes(back) == tree_shapes(shapes)
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n


# -- FD targets and data ------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3])
def test_fd_maps_equal(n):
    for m in _masks():
        np.testing.assert_array_equal(fd.fd_maps(m, n), jfd.fd_maps(m, n))


def test_fourier_coefficients_equal():
    rng = np.random.default_rng(4)
    for pts in (rng.integers(0, 50, (40, 2)), np.zeros((5, 2), np.int64),
                rng.standard_normal((7, 2))):
        np.testing.assert_array_equal(fd.fourier_coefficients(pts, 5),
                                      jfd.fourier_coefficients(pts, 5))


def test_contour_finders_equal():
    """cv2's finder (both packages use it where cv2 is installed) and the
    marching-squares fallback give JAX's point lists."""
    for m in _masks():
        for mine, theirs in ((fd._find_contours_trace,
                              jfd._find_contours_trace),
                             (fd._find_contours_cv2,
                              jfd._find_contours_cv2)):
            got, want = mine(m), theirs(m)
            assert len(got) == len(want) > 0
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_prepare_dataset_equal():
    got = pipe.prepare_dataset(_images(), _masks(), fd_channel=2)
    want = jpipe.prepare_dataset(_images(), _masks(), fd_channel=2)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# -- the trainer --------------------------------------------------------------


def test_loss_and_adadelta_step():
    """The loss (per-head MSE + CCE clipped at 1e-7) and one Adadelta step
    (lr 0.01) from the same weights and batch, at dropout 0: the loss
    within 1e-5, every parameter within 1e-4 scale-relative of optax's."""
    x, fd_t, y_t = pipe.prepare_dataset(_images(2), _masks(2), fd_channel=2)
    batch = (x, fd_t, y_t)
    jt = jpipe.FourierNetTrainer(fd_channel=2, features=FEATURES,
                                 dropout=0.0)
    params = jax_variables(jt.model, jnp.asarray(x[:1]), train=False)[
        "params"]

    @jax.jit
    def step(params):
        loss, grads = jax.value_and_grad(jt._loss)(params, batch, {})
        updates, _ = jt.tx.update(grads, jt.tx.init(params), params)
        return loss, jax.tree.map(lambda p, u: p + u, params, updates)

    loss, new = step(params)
    tt = pipe.FourierNetTrainer(fd_channel=2, features=FEATURES,
                                dropout=0.0, device="cpu")
    lm = layer_map(tt.model)
    tt.model.load_state_dict(state_dict_from_jax({"params": params}, lm))
    opt = tt.init()
    got = tt.loss(batch, train=True)
    got.backward()
    opt.step()
    assert got.item() == pytest.approx(float(loss), rel=1e-5)
    mine = dict(jax.tree_util.tree_leaves_with_path(
        variables_from_state_dict(tt.model.state_dict(), lm)["params"]))
    for path, w in jax.tree_util.tree_leaves_with_path(new):
        w = np.asarray(w)
        assert np.abs(mine[path] - w).max() <= TOL * np.abs(w).max(), path


def test_fit_and_predict():
    """Two epochs at batch 2 on the CPU: a finite history, the best
    validation state loaded, class-1 probabilities out of ``predict``."""
    data = pipe.prepare_dataset(_images(4), _masks(4), fd_channel=1)
    val = tuple(a[:2] for a in data)
    tt = pipe.FourierNetTrainer(features=FEATURES, max_epochs=2,
                                batch_size=2, device="cpu")
    best = tt.fit(data, val)
    assert [h["epoch"] for h in tt.history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"])
               for h in tt.history)
    for k, t in tt.model.state_dict().items():
        assert torch.equal(t, best[k]), k
    probs = tt.predict(None, data[0], batch_size=3)
    assert probs.shape == (4, HW, HW)
    assert probs.min() >= 0.0 and probs.max() <= 1.0
    again = tt.predict(best, data[0], batch_size=3)
    np.testing.assert_array_equal(probs, again)
