"""The port's training slice against the JAX package, on the CPU.

* losses: value and dlogits at rtol 1e-5;
* optimizers: five steps against optax at rtol 1e-6;
* ``packed_unet_apply`` (U-Net f=8, 7 classes, 32x32, batch 2; the JAX side
  runs its Pallas kernels in interpret mode) at the tolerances of
  ``tests/test_packed_unet.py``: logits 0.08, BN stats rtol 0.05 / atol
  1e-3, the whole gradient at cosine > 0.95 with its norm within 5%, each
  tensor's gradient within limits set by JAX's own bf16 rounding (see
  ``test_packed_gradients_match_jax``), one Adam step of
  ``make_packed_train_step``: loss within 2%, parameters rtol 0.1 / atol
  2e-3;
* ``Trainer.fit``: two steps on the same arrays, train loss within 2%;
* data, input pipeline, checkpoints, early stopping, metrics, the CLI.

Weights go from the port's seeded U-Net to the JAX variable tree through
``utils/convert.unet_variables_from_state_dict``.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from retinal_oct_image_segmentation_via_deep_learning_tpu import config as jcfg
from retinal_oct_image_segmentation_via_deep_learning_tpu.metrics.region import (
    per_class_dice as j_per_class_dice,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    checkpoint as jckpt,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    data as jdata,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    losses as jlosses,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    packed_unet as jpacked,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
    train_state as jts,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
    TrainConfig,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.metrics.region import (
    per_class_dice,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    UNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    data as tdata,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    losses as tlosses,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    packed_unet as tpacked,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.checkpoint import (
    CheckpointManager,
    EarlyStopping,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.input_pipeline import (
    prefetch_to_device,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
    create_train_state,
    make_optimizer,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
    Trainer,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    unet_variables_from_state_dict,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.logging import (
    MetricLogger,
)

F, NC, HW = 8, 7, 32


def _flat(tree, prefix=""):
    """Nested dicts -> {"a/b/c": leaf as float32 numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


def _jax_tree(model, overrides=None):
    """The port model's state dict, with ``overrides`` (name -> tensor), in
    the JAX variable layout, flattened."""
    sd = dict(model.state_dict())
    sd.update(overrides or {})
    return _flat(unet_variables_from_state_dict(sd))


def _unet(seed=0):
    return UNet(1, NC, F, generator=torch.Generator().manual_seed(seed))


# --------------------------------------------------------------- losses


@pytest.mark.parametrize("name", ["dice_ce", "dice", "ce", "mse"])
@pytest.mark.parametrize("weighted", [False, True])
def test_losses_match_jax(name, weighted):
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (2, 6, 5, 4)).astype(np.float32)
    labels = rng.integers(0, 4, (2, 6, 5))
    cw = [0.5, 1.0, 2.0, 1.5] if weighted else None
    if name == "mse":
        target = rng.normal(0, 1, logits.shape).astype(np.float32)
        jl = jlosses.get_loss(name)
        want, want_g = jax.value_and_grad(lambda z: jl(z, target, cw))(
            jnp.asarray(logits))
        t = torch.tensor(logits, requires_grad=True)
        got = tlosses.get_loss(name)(t, torch.tensor(target), cw)
    else:
        jl = jlosses.get_loss(name)
        want, want_g = jax.value_and_grad(lambda z: jl(z, labels, cw))(
            jnp.asarray(logits))
        t = torch.tensor(logits, requires_grad=True)
        got = tlosses.get_loss(name)(t, torch.tensor(labels), cw)
    (g,) = torch.autograd.grad(got, t)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5 * float(np.abs(want_g).max()))


# ----------------------------------------------------------- optimizers


OPTIMIZERS = [
    OptimConfig(optimizer="adam", learning_rate=1e-2),
    OptimConfig(optimizer="adamw", learning_rate=1e-2, weight_decay=0.1),
    OptimConfig(optimizer="sgd", learning_rate=1e-2, momentum=0.9),
    OptimConfig(optimizer="adadelta", learning_rate=1.0),
    OptimConfig(optimizer="adam", learning_rate=1e-2, warmup_steps=2,
                decay_steps=4, lr_min_ratio=0.1, grad_clip_norm=0.5),
]


@pytest.mark.parametrize("cfg", OPTIMIZERS,
                         ids=["adam", "adamw", "sgd", "adadelta",
                              "adam_warmup_cosine_clip"])
def test_optimizer_matches_optax(cfg):
    """Five steps on one float32 tensor with the same gradients: rtol 1e-6,
    plus four float32 ulps of the largest parameter (AdamW: torch applies
    the decay as its own multiply, p * (1 - lr * wd), where optax adds wd *
    p into the update, so the two round differently)."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(0, 1, (4, 3)).astype(np.float32)
    grads = rng.normal(0, 1, (5, 4, 3)).astype(np.float32)

    tx = jts.make_optimizer(jcfg.OptimConfig(**vars(cfg)))
    pj = jnp.asarray(p0)
    opt_state = tx.init(pj)
    for g in grads:
        upd, opt_state = tx.update(jnp.asarray(g), opt_state, pj)
        pj = optax.apply_updates(pj, upd)

    p = torch.nn.Parameter(torch.tensor(p0))
    state = create_train_state(torch.nn.ParameterList([p]), cfg)
    for g in grads:
        p.grad = torch.tensor(g)
        state.apply_gradients()
    assert state.step == 5
    np.testing.assert_allclose(
        p.detach().numpy(), np.asarray(pj), rtol=1e-6,
        atol=4 * float(np.spacing(np.abs(np.asarray(pj)).max())))


def test_optimizer_rejects_unknown_name():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(OptimConfig(optimizer="lamb"), [torch.zeros(1)])


def test_config_defaults_match_jax():
    for ours, theirs in ((OptimConfig(), jcfg.OptimConfig()),
                         (DataConfig(), jcfg.DataConfig()),
                         (TrainConfig(), jcfg.TrainConfig())):
        for field, value in vars(ours).items():
            if not dataclasses.is_dataclass(value):
                assert getattr(theirs, field) == value, field


# ------------------------------------------------- packed_unet vs JAX


def _record_grads():
    """An optax stage that keeps the incoming gradients in its state and
    passes them on unchanged."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))


@pytest.fixture(scope="module")
def packed_case():
    """Both sides of the packed comparisons, computed once: the seeded
    port U-Net, its weights in JAX, JAX's forward (both conv settings) and
    one JAX ``make_packed_train_step`` with Adam 1e-3 on dice_ce."""
    model = _unet()
    v = unet_variables_from_state_dict(model.state_dict())
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((2, HW, HW, 1)),
                     dtype=torch.bfloat16)
    y = rng.integers(0, NC, (2, HW, HW))
    xj = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    fwd = {}
    for port_kw, jax_kw in (({}, {}),
                            ({"deep": "kernel", "mid": "kernel"},
                             {"deep": "psrp", "mid": "psrp"})):
        logits, stats = jax.jit(
            lambda v_, x_, kw=jax_kw: jpacked.packed_unet_apply(v_, x_, **kw)
        )(v, xj)
        fwd[tuple(sorted(port_kw.items()))] = (np.asarray(logits, np.float32),
                                               _flat(stats))
    jstate = jts.TrainState.create(
        apply_fn=None, params=v["params"], batch_stats=v["batch_stats"],
        tx=optax.chain(_record_grads(), optax.adam(1e-3)))
    new_state, loss = jax.jit(
        jpacked.make_packed_train_step(jlosses.dice_ce_loss))(
            jstate, xj, jnp.asarray(y))
    step = {"loss": float(loss), "grads": _flat(new_state.opt_state[0]),
            "params": _flat(new_state.params),
            "batch_stats": _flat({"x": new_state.batch_stats})}
    return {"model": model, "x": x, "y": torch.tensor(y), "fwd": fwd,
            "step": step}


@pytest.mark.parametrize("kw", [{}, {"deep": "kernel", "mid": "kernel"}],
                         ids=["torch", "kernel"])
def test_packed_forward_matches_jax(packed_case, kw):
    model = packed_case["model"]
    want_logits, want_stats = packed_case["fwd"][tuple(sorted(kw.items()))]
    with torch.no_grad():
        logits, new_stats = tpacked.packed_unet_apply(model,
                                                      packed_case["x"], **kw)
    assert logits.shape == (2, HW, HW, NC) and logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(), want_logits,
                               rtol=0.08, atol=0.08)
    assert len(new_stats) == 18
    got = _jax_tree(model, {f"{n}.running_{k}": t for n, (m, v) in
                            new_stats.items() for k, t in (("mean", m),
                                                           ("var", v))})
    for path, leaf in want_stats.items():
        np.testing.assert_allclose(got["batch_stats/" + path], leaf,
                                   rtol=0.05, atol=1e-3, err_msg=path)


@pytest.fixture(scope="module")
def port_step(packed_case):
    """One port ``make_packed_train_step`` (Adam 1e-3, dice_ce) from the
    same weights: loss, gradients, parameters and running stats after."""
    model = _unet()
    state = create_train_state(model, OptimConfig())
    step = tpacked.make_packed_train_step(tlosses.dice_ce_loss)
    loss = float(step(state, packed_case["x"], packed_case["y"]))
    grads = {n: p.grad for n, p in model.named_parameters()}
    return {"loss": loss, "grads": _jax_tree(model, grads),
            "after": _jax_tree(model), "state": state}


def _float32_gradients(x, y):
    """Gradients of the same loss through the port's U-Net in float32
    (train mode, library convs, no bf16): the reference both bf16
    gradients are held to."""
    model = _unet()
    model.train()
    logits = model(x.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    tlosses.dice_ce_loss(logits, y).backward()
    return _jax_tree(model, {n: p.grad for n, p in model.named_parameters()})


def _cos_ratio(a, b):
    a, b = a.ravel().astype(np.float64), b.ravel().astype(np.float64)
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    return float(a @ b / (na * nb + 1e-30)), nb / (na + 1e-30)


def test_packed_gradients_match_jax(packed_case, port_step):
    """Whole gradient: cosine > 0.95 and norm within 5% of JAX's.

    Per tensor, each limit is set against JAX's own bf16 rounding: c_J, the
    cosine of JAX's bf16 gradient to the float32 gradient of the same
    weights and batch (the port's U-Net in float32). Two bf16 gradients
    whose rounding errors are independent and each as large as JAX's meet
    at a cosine of about c_J ** 2, so:

    * where the norm is above 2e-3, port against JAX directly: cosine >=
      c_J ** 2 - 0.02, and port against float32: cosine >= c_J - 0.05;
    * every tensor: the norm ratio to float32 within 0.1 of JAX's.

    At this size bf16 rounding alone moves a gradient far: c_J is below 0.95
    on several deep tensors (0.930 at the lowest, blk4's first conv), so the
    port and JAX cannot meet a fixed 0.95 per tensor against each other.
    Readings on the CPU, seeds as here: the direct cosine is at most 0.011
    below c_J ** 2 (blk8's first BN bias), the float32 cosine at most 0.027
    below c_J (blk2's first BN scale), and the norm ratio at most 0.075
    further from 1 than JAX's (blk2's second BN scale)."""
    want = packed_case["step"]["grads"]
    got = {k[len("params/"):]: v for k, v in port_step["grads"].items()
           if k.startswith("params/")}
    assert len(want) == len(got) == 64  # 18 convs, 18 BN, 4 ct, the head
    cos, ratio = _cos_ratio(np.concatenate([want[k].ravel() for k in want]),
                            np.concatenate([got[k].ravel() for k in want]))
    assert cos > 0.95 and abs(ratio - 1) < 0.05, (cos, ratio)

    ref = _float32_gradients(packed_case["x"], packed_case["y"])
    # (how far each reading falls short of JAX's, tensor) -> its limit
    worst = {"cos to JAX": ((-1.0, ""), 0.02),
             "cos to float32": ((-1.0, ""), 0.05),
             "norm ratio": ((-1.0, ""), 0.1)}

    def short(kind, by, path):
        worst[kind] = (max(worst[kind][0], (by, path)), worst[kind][1])

    for path in want:
        r = ref["params/" + path]
        cos_j, ratio_j = _cos_ratio(r, want[path])
        cos_p, ratio_p = _cos_ratio(r, got[path])
        cos_pj, _ = _cos_ratio(want[path], got[path])
        if max(np.linalg.norm(want[path]), np.linalg.norm(got[path])) > 2e-3:
            short("cos to JAX", cos_j ** 2 - cos_pj, path)
            short("cos to float32", cos_j - cos_p, path)
        short("norm ratio", abs(ratio_p - 1) - abs(ratio_j - 1), path)
    for kind, ((by, path), limit) in worst.items():
        print(f"{kind}: at most {by:.4f} short of JAX's ({path}), limit "
              f"{limit}")
    assert all(by <= limit for (by, _), limit in worst.values()), worst


def test_packed_adam_step_matches_jax(packed_case, port_step):
    want = packed_case["step"]
    assert abs(port_step["loss"] - want["loss"]) < 0.02 * max(
        1.0, want["loss"])
    assert port_step["state"].step == 1
    for path, leaf in want["params"].items():
        np.testing.assert_allclose(port_step["after"]["params/" + path],
                                   leaf, rtol=0.1, atol=2e-3, err_msg=path)
    for path, leaf in want["batch_stats"].items():
        np.testing.assert_allclose(
            port_step["after"]["batch_stats/" + path[2:]], leaf, rtol=0.05,
            atol=1e-3, err_msg=path)


def test_remat_matches_no_remat_and_applies_stats_once(packed_case):
    """``remat=True`` recomputes each block in the backward: the same
    logits (1e-5) and gradients, and after one step every running stat is
    0.9 * old + 0.1 * batch, moved once, as without remat."""
    x, y = packed_case["x"], packed_case["y"]
    out = []
    for remat in (False, True):
        model = _unet()
        logits, stats = tpacked.packed_unet_apply(model, x, remat=remat)
        once = _jax_tree(model, {f"{n}.running_{k}": t for n, (m, v) in
                                 stats.items() for k, t in (("mean", m),
                                                            ("var", v))})
        state = create_train_state(model, OptimConfig(learning_rate=0.0))
        tpacked.make_packed_train_step(tlosses.dice_ce_loss, remat=remat)(
            state, x, y)
        after = _jax_tree(model)
        for path, leaf in once.items():
            if path.startswith("batch_stats/"):
                np.testing.assert_allclose(after[path], leaf, rtol=1e-6,
                                           atol=1e-8, err_msg=path)
        out.append((logits.detach().float().numpy(), after,
                    {n: p.grad.clone() for n, p in model.named_parameters()}))
    (la, ta, ga), (lb, tb, gb) = out
    np.testing.assert_allclose(la, lb, rtol=1e-5, atol=1e-5)
    for path, leaf in ta.items():
        np.testing.assert_allclose(tb[path], leaf, rtol=1e-6, atol=1e-8,
                                   err_msg=path)
    for name in ga:
        np.testing.assert_allclose(gb[name].numpy(), ga[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def _step_grads(x, y, **kw):
    """One packed step (lr 0) from the seeded U-Net: loss and gradients."""
    model = _unet()
    state = create_train_state(model, OptimConfig(learning_rate=0.0))
    loss = tpacked.make_packed_train_step(tlosses.dice_ce_loss, **kw)(
        state, x, y)
    return float(loss), {n: p.grad.double() for n, p in
                         model.named_parameters()}


def test_packed_fused_loss_step_matches_unfused(packed_case):
    """``fused_loss=True`` (K8/K9's plain versions here) against the
    unfused dice_ce step from the same state: loss within 1e-6 relative,
    and every gradient tensor above a norm of 1e-3 at cosine > 0.9999.
    (Not against the JAX fused step: at W < 128 JAX takes its XLA loss.)"""
    x, y = packed_case["x"], packed_case["y"]
    loss_u, grads_u = _step_grads(x, y, fused_loss=False)
    loss_f, grads_f = _step_grads(x, y, fused_loss=True)
    assert abs(loss_f - loss_u) <= 1e-6 * abs(loss_u), (loss_f, loss_u)
    checked = 0
    for name, gu in grads_u.items():
        gf = grads_f[name]
        if max(float(gu.norm()), float(gf.norm())) > 1e-3:
            cos = float(gu.flatten() @ gf.flatten()) / float(gu.norm()
                                                             * gf.norm())
            assert cos > 0.9999, (name, cos)
            checked += 1
    assert checked > 30


def _conv_bn_then_relu(h, conv, bn, impl):
    """The packed step's conv-BN-ReLU as it was before the ReLU joined
    ``bn_train``: the ReLU as its own op after it."""
    y, mean, var = tpacked.bn_train(
        tpacked._CONVS[impl](h.to(torch.bfloat16), conv.weight), bn.weight,
        bn.bias)
    return torch.relu(y), mean, var


@pytest.mark.parametrize("kw", [{}, {"remat": True},
                                {"deep": "kernel", "mid": "kernel"}],
                         ids=["torch", "remat", "kernel"])
def test_packed_step_with_relu_in_bn_train_equals_the_step_before(
        packed_case, monkeypatch, kw):
    """The packed step with the ReLU inside ``bn_train`` (K13, K14 and
    K6's masked mode on the card; their plain versions here) gives the
    loss and every gradient of the step that ran ``torch.relu`` after it,
    bit for bit."""
    x, y = packed_case["x"], packed_case["y"]
    loss, grads = _step_grads(x, y, **kw)
    monkeypatch.setattr(tpacked, "_conv_bn_relu", _conv_bn_then_relu)
    loss_before, grads_before = _step_grads(x, y, **kw)
    assert loss == loss_before
    assert grads.keys() == grads_before.keys()
    for name, g in grads.items():
        assert torch.equal(g, grads_before[name]), name


def test_fused_loss_switch_reads_the_environment(packed_case, monkeypatch):
    """``fused_loss=None`` reads ``OCTSEG_PACKED_FUSED_LOSS`` as the JAX
    package does; the trainer reaches it that way."""
    calls = []

    def spy(*args):
        calls.append(1)
        return tlosses.dice_ce_loss(*args)

    monkeypatch.setattr(tpacked, "dice_ce_loss_fused", spy)
    x, y = packed_case["x"][:1, :16, :16], packed_case["y"][:1, :16, :16]
    for env, want in (("0", 0), ("1", 1)):
        monkeypatch.setenv("OCTSEG_PACKED_FUSED_LOSS", env)
        _step_grads(x, y)
        assert len(calls) == want


def test_packed_step_raises_where_unported_or_unsupported():
    with pytest.raises(ValueError, match="fused_loss computes dice_ce"):
        tpacked.make_packed_train_step(tlosses.softmax_cross_entropy,
                                       fused_loss=True)
    with pytest.raises(ValueError, match="deep"):
        tpacked.make_packed_train_step(tlosses.dice_ce_loss, deep="psrp")
    with pytest.raises(ValueError, match="divisible by 16"):
        tpacked.packed_unet_apply(_unet(), torch.zeros(1, 24, 32, 1))


# ---------------------------------------------------------------- trainer


def _arrays(n=16, seed=4):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (n, HW, HW, 1)).astype(np.float32)
    labels = rng.integers(0, NC, (n, HW, HW)).astype(np.int32)
    return images, labels


def test_trainer_fit_matches_jax():
    """The non-packed path with the default config (Adam 1e-3, dice_ce,
    bf16 compute, z-score): two steps on the same arrays, in the same
    order, from the same weights."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training.trainer import (
        Trainer as JTrainer,
    )

    images, labels = _arrays()
    kw = {"init_features": F}
    cfg = TrainConfig(model=ModelConfig(num_classes=NC, kwargs=kw),
                      num_epochs=1)
    model = _unet(5)
    v = unet_variables_from_state_dict(model.state_dict())

    jt = JTrainer(jcfg.TrainConfig(
        model=jcfg.ModelConfig(num_classes=NC, kwargs=kw), num_epochs=1))
    jstate = jts.create_train_state(jt.model, v, jcfg.OptimConfig())
    jt.fit(jdata.numpy_folder_dataset(images, labels, 8), state=jstate)

    tt = Trainer(cfg, device="cpu")
    state = create_train_state(model, cfg.optim)
    tt.fit(tdata.numpy_folder_dataset(images, labels, 8), state=state)
    assert state.step == 2
    want = jt.history[0]["train_loss"]
    got = tt.history[0]["train_loss"]
    assert abs(got - want) < 0.02 * want, (got, want)


def test_trainer_fit_eval_checkpoint_and_predict(tmp_path):
    """Port only: packed training with validation, checkpoints, early
    stopping and the best state; predictions are label maps."""
    images, labels = _arrays(8, seed=6)
    cfg = TrainConfig(
        model=ModelConfig(num_classes=NC, kwargs={"init_features": 4}),
        data=DataConfig(batch_size=4), num_epochs=3, early_stop_patience=1,
        checkpoint_dir=str(tmp_path), keep_checkpoints=2, packed_train=True,
        optim=OptimConfig(learning_rate=0.0))
    tt = Trainer(cfg, device="cpu")
    ds = tdata.numpy_folder_dataset(images, labels, 4, seed=1)
    val = tdata.numpy_folder_dataset(images[:4], labels[:4], 4,
                                     shuffle=False)
    state = tt.fit(ds, val)
    # lr 0: the weights never move, so the validation loss stops improving
    # and patience 1 stops the run after the second epoch
    assert [r["epoch"] for r in tt.history] == [0, 1]
    assert all(math.isfinite(r["val_loss"]) and len(r["val_dice"]) == NC
               for r in tt.history)
    # the state returned is the best one: after epoch 0's two steps
    assert state.step == 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_0.pt",
                                                          "ckpt_1.pt"]
    preds = tt.predict(state, torch.from_numpy(images[:2]))
    assert preds.shape == (2, HW, HW) and preds.dtype == torch.int64
    assert int(preds.min()) >= 0 and int(preds.max()) < NC


def test_trainer_rejects_packed_for_other_models():
    cfg = TrainConfig(model=ModelConfig(num_classes=NC,
                                        kwargs={"init_features": 4}),
                      packed_train=True)
    tt = Trainer(cfg, device="cpu")
    tt.cfg = TrainConfig(model=ModelConfig(name="relaynet"),
                         packed_train=True)
    with pytest.raises(ValueError, match="flagship"):
        tt.train_step_fn()


def test_early_stopping_matches_jax():
    seq = [1.0, 0.9, 0.95, 0.97, 0.8, 0.85, 0.86, 0.87]
    for patience in (None, 1, 2, 3):
        a, b = EarlyStopping(patience), jckpt.EarlyStopping(patience)
        for i, v in enumerate(seq):
            assert a.update(i, v) == b.update(i, v)
            assert (a.best, a.best_step, a.bad_epochs) == \
                (b.best, b.best_step, b.bad_epochs)


def test_checkpoint_manager_keeps_best_and_restores(tmp_path):
    model = UNet(1, 3, 4)
    state = create_train_state(model, OptimConfig())
    mgr = CheckpointManager(str(tmp_path), keep=2)
    assert mgr.restore_best(state) is None
    saved = {}
    for step, vloss in ((0, 0.5), (1, 0.3), (2, 0.4), (3, 0.6)):
        with torch.no_grad():
            model.conv.bias.fill_(float(step))
        state.step = step
        mgr.save(step, state, {"val_loss": vloss})
        saved[step] = model.conv.bias.clone()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_1.pt",
                                                          "ckpt_2.pt"]
    assert mgr.best_step() == 1 and mgr.latest_step() == 2
    assert mgr.restore_best(state) is state and state.step == 1
    assert torch.equal(model.conv.bias, saved[1])
    again = CheckpointManager(str(tmp_path), keep=2)  # re-reads the files
    again.restore_latest(state)
    assert state.step == 2 and torch.equal(model.conv.bias, saved[2])


# ------------------------------------------- data, pipeline, metrics, CLI


def test_numpy_folder_dataset_matches_jax_order():
    images, labels = _arrays(10)
    a = tdata.numpy_folder_dataset(images, labels, 3, seed=7)
    b = jdata.numpy_folder_dataset(images, labels, 3, seed=7)
    assert a.steps_per_epoch == b.steps_per_epoch == 3
    for epoch in range(2):
        for (xa, ya), (xb, yb) in zip(a.epoch(epoch), b.epoch(epoch)):
            np.testing.assert_array_equal(xa.numpy(), np.asarray(xb))
            np.testing.assert_array_equal(ya.numpy(), np.asarray(yb))


def test_synthetic_dataset_shapes_classes_and_statistics():
    """Same distributions as the JAX generator (its samples are not
    reproduced): label range, class fractions and intensity statistics
    agree within sampling noise, and a batch depends only on (seed,
    epoch, step)."""
    cfg = tdata.SyntheticOCTConfig(height=64, width=64, num_layers=4)
    ds = tdata.SyntheticOCTDataset(cfg, 32, 16, device="cpu")
    batches = list(ds.epoch(0))
    assert len(batches) == 2
    x, y = batches[0]
    assert x.shape == (16, 64, 64, 1) and x.dtype == torch.float32
    assert y.shape == (16, 64, 64) and y.dtype == torch.int64
    assert int(y.min()) == 0 and int(y.max()) == cfg.num_classes - 1
    again, _ = next(ds.epoch(0))
    assert torch.equal(again, x)
    assert not torch.equal(next(ds.epoch(1))[0], x)

    jc = jdata.SyntheticOCTConfig(height=64, width=64, num_layers=4)
    jx, jy = jdata.synth_batch(jax.random.PRNGKey(0), 32, jc)
    jx, jy = np.asarray(jx)[..., 0], np.asarray(jy)
    tx = torch.cat([b[0] for b in batches])[..., 0].numpy()
    ty = torch.cat([b[1] for b in batches]).numpy()
    for c in range(cfg.num_classes):
        frac_t, frac_j = (ty == c).mean(), (jy == c).mean()
        # the fluid pockets' share varies most from batch to batch
        assert abs(frac_t - frac_j) < 0.03 + 0.3 * frac_j, (c, frac_t, frac_j)
        for stat in (np.mean, np.std):
            np.testing.assert_allclose(stat(tx[ty == c]), stat(jx[jy == c]),
                                       rtol=0.05, err_msg=f"class {c}")


def test_prefetcher_moves_batches_and_reraises():
    batches = [(torch.full((2,), i), torch.full((1,), -i)) for i in range(5)]
    got = list(prefetch_to_device(iter(batches), "cpu",
                                  transform=lambda b: (b[0] * 2, b[1])))
    assert [int(a[0]) for a, _ in got] == [0, 2, 4, 6, 8]

    def broken():
        yield batches[0]
        raise KeyError("producer failed")

    it = prefetch_to_device(broken(), "cpu")
    next(it)
    with pytest.raises(KeyError, match="producer failed"):
        next(it)


def test_per_class_dice_matches_jax():
    rng = np.random.default_rng(9)
    yt = rng.integers(0, 5, (3, 8, 8))
    yp = np.where(rng.uniform(size=yt.shape) < 0.7, yt,
                  rng.integers(0, 5, yt.shape))
    yp[yp == 4] = 3  # a class that is never predicted
    want = j_per_class_dice(jnp.asarray(yt), jnp.asarray(yp), 5)
    got = per_class_dice(torch.tensor(yt), torch.tensor(yp), 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_metric_logger_writes_jsonl(tmp_path, capsys):
    path = tmp_path / "sub" / "log.jsonl"
    log = MetricLogger(str(path))
    log.log({"epoch": 0, "loss": torch.tensor(0.25),
             "dice": torch.tensor([0.5, 1.0]), "n": np.int64(3)})
    assert json.loads(path.read_text()) == {"epoch": 0, "loss": 0.25,
                                            "dice": [0.5, 1.0], "n": 3}
    assert "loss=0.25" in capsys.readouterr().out


@pytest.mark.parametrize("packed", [[], ["--packed"], ["--packed", "remat"]],
                         ids=["unpacked", "packed", "packed_remat"])
def test_cli_train_on_cpu(tmp_path, packed):
    log = tmp_path / "log.jsonl"
    argv = ["train", "--device", "cpu", "--image-size", "32",
            "--batch-size", "2", "--num-train", "4", "--num-val", "2",
            "--epochs", "1", "--num-classes", "5", "--model-kwargs",
            '{"init_features": 4}', "--log-file", str(log),
            "--checkpoint-dir", str(tmp_path / "ckpt"), *packed]
    state = cli.cmd_train(cli.parser().parse_args(argv))
    assert state.step == 2
    rec = json.loads(log.read_text().splitlines()[0])
    assert math.isfinite(rec["train_loss"]) and math.isfinite(rec["val_loss"])
    args = cli.parser().parse_args(argv)
    trainer, _, _ = cli.build_training(args)
    assert trainer.cfg.packed_train == (packed[-1] if len(packed) == 2
                                        else bool(packed))


def test_cli_train_refuses_real_data_and_a_missing_card(tmp_path):
    """A ``--data`` directory that is not there raises what the JAX CLI's
    reader raises (the loaders are ported); a missing card exits."""
    missing = tmp_path / "data"
    args = cli.parser().parse_args(["train", "--device", "cpu", "--data",
                                    f"duke:{missing}"])
    with pytest.raises(FileNotFoundError, match=str(missing)):
        jdata.make_datasets(f"duke:{missing}", (32, 32), 2)
    with pytest.raises(FileNotFoundError, match=str(missing)):
        cli.build_training(args)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.build_training(cli.parser().parse_args(["train"]))


def test_state_dict_round_trip_through_jax_layout():
    """Port state dict -> JAX layout -> port state dict is the identity,
    and the ``CheckpointUNetBlock_N`` spelling is read too."""
    model = _unet(2)
    sd = model.state_dict()
    for remat in (False, True):
        v = unet_variables_from_state_dict(sd, remat_stages=remat)
        assert ("CheckpointUNetBlock_3" in v["params"]) == remat
        back = unet_state_dict_from_jax(v)
        assert list(back) == list(sd)
        for k in sd:
            assert torch.equal(back[k], sd[k]), k
