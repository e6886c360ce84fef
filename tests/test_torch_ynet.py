"""The port's Y-Net (``models/unet.YNet``: ``y_net_gen`` and
``y_net_gen_ffc``) against the JAX package's on the same numpy-seeded
inputs and weights, carried by ``utils/convert.layer_map``: both encoders,
``cat_merge`` on and off, ``skip_ffc``, in eval and train mode at 1e-4
scale-relative; one Y-Net-FFC gradient at cosine > 0.9999; the parameter
tree at the default width; and the CLI's reach to the new names (``train``
through ``Trainer`` at 32x32, ``infer`` / ``eval`` with ``--quantize off``,
``train`` of FourierNet and AnoGAN refused with their trainers' names)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    unet as junet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    unet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    layer_map,
    state_dict_from_jax,
    variables_from_state_dict,
)
from test_torch_common import (
    jax_variables,
    nchw,
    normal_images,
    scale_rel,
    tree_shapes,
)

F, NC, HW = 8, 3, 32
TOL = 1e-4
# (ffc, cat_merge, skip_ffc)
CASES = [(True, True, False), (True, False, True), (False, True, False),
         (False, False, True)]


def _ids(c):
    return "{}-{}-{}".format("ffc" if c[0] else "plain",
                             "catmerge" if c[1] else "concat",
                             "skipffc" if c[2] else "noskip")


@functools.lru_cache(maxsize=None)
def _jax_case(case):
    """(input, variables, cotangent, eval logits, train logits, batch_stats
    after the train call[, gradient of sum(train logits * cot), for the
    first case]) of the JAX Y-Net, one compile."""
    ffc, cat_merge, skip_ffc = case
    jm = junet.YNet(num_classes=NC, init_features=F, ffc=ffc,
                    cat_merge=cat_merge, skip_ffc=skip_ffc)
    x = normal_images(1, 2, HW)
    v = jax_variables(jm, jnp.asarray(x))
    cot = np.random.default_rng(2).standard_normal((2, HW, HW, NC)).astype(
        np.float32)

    def both(v, x):
        def loss(params):
            out, mut = jm.apply({"params": params,
                                 "batch_stats": v["batch_stats"]}, x,
                                train=True, mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut)

        (_, (train, mut)), g = jax.value_and_grad(loss, has_aux=True)(
            v["params"])
        out = (jm.apply(v, x, train=False), train, mut["batch_stats"])
        return out + ((g,) if case == CASES[0] else ())

    return (x, v, cot) + tuple(jax.jit(both)(v, jnp.asarray(x)))


def _port_ynet(case, v):
    ffc, cat_merge, skip_ffc = case
    tm = unet.YNet(1, NC, F, ffc=ffc, cat_merge=cat_merge,
                   skip_ffc=skip_ffc, generator=torch.Generator())
    tm.load_state_dict(state_dict_from_jax(v, layer_map(tm)))
    return tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_ynet_forward(case, train):
    x, v, _, want_eval, want_train, stats = _jax_case(case)[:6]
    tm = _port_ynet(case, v)
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


def test_ynet_ffc_gradient():
    """One train-mode gradient of the Y-Net-FFC (its FFTs' backward, the
    stream BatchNorms' K6 plain version) against ``jax.grad``: whole
    gradient cosine > 0.9999, every tensor above a norm of 1e-3 too."""
    case = CASES[0]
    x, v, cot, _, _, _, grads = _jax_case(case)
    tm = _port_ynet(case, v).train()
    out = tm(nchw(x))
    torch.sum(out * nchw(cot)).backward()
    g = {n: p.grad for n, p in tm.named_parameters()}
    got = variables_from_state_dict(
        {**tm.state_dict(), **g}, layer_map(tm))["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(grads))
    u, w = [], []
    for path, leaf in jax.tree_util.tree_leaves_with_path(got):
        a, b = leaf.ravel(), np.asarray(want[path]).ravel()
        u.append(a)
        w.append(b)
        if np.linalg.norm(b) > 1e-3:
            cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
            assert cos > 0.9999, (jax.tree_util.keystr(path), cos)
    u, w = np.concatenate(u), np.concatenate(w)
    assert u @ w / (np.linalg.norm(u) * np.linalg.norm(w)) > 0.9999


def test_cat_merge_interleave():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    b = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    want = junet._cat_merge_interleave(jnp.asarray(a), jnp.asarray(b))
    assert scale_rel(unet._cat_merge_interleave(nchw(a), nchw(b)),
                     want) == 0.0


@pytest.mark.parametrize("name", ["y_net_gen", "y_net_gen_ffc"])
def test_default_width_parameters(name):
    """The registry's model at the JAX defaults (f=32, 9 classes): the
    layer map's tree equals ``jax.eval_shape`` of the JAX model's init,
    leaf for leaf, and so does the parameter count."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    jm = jax_get_model(name)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))
    tm = get_model(name)
    back = variables_from_state_dict(tm.state_dict(), layer_map(tm))
    assert tree_shapes(back) == tree_shapes(shapes)
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert sum(p.numel() for p in tm.parameters()) == n


# -- the CLI ----------------------------------------------------------------


def _train_args(name, tmp_path, kwargs):
    return ["train", "--model", name, "--device", "cpu", "--image-size",
            "32", "--batch-size", "2", "--num-train", "4", "--num-val", "2",
            "--epochs", "1", "--num-classes", "4", "--dtype", "float32",
            "--model-kwargs", kwargs, "--log-file",
            str(tmp_path / "log.jsonl")]


@pytest.mark.parametrize("name,kwargs", [
    ("y_net_gen", '{"init_features": 8}'),
    ("y_net_gen_ffc", '{"init_features": 8}'),
    ("edgeal", '{"ngf": 8, "n_blocks": 1, "n_downsampling": 2}'),
])
def test_cli_train_zoo(name, kwargs, tmp_path):
    """``cli train`` trains the new segmentation models through
    ``Trainer`` at 32x32 on the CPU: one epoch, finite losses."""
    state = cli.main(_train_args(name, tmp_path, kwargs))
    assert state.step == 2
    lines = (tmp_path / "log.jsonl").read_text().splitlines()
    assert len(lines) == 1 and "val_loss" in lines[0]
    assert np.isfinite(float(lines[0].split('"train_loss": ')[1]
                             .split(",")[0]))


@pytest.mark.parametrize("name,trainer", [
    ("fouriernet", "FourierNetTrainer"), ("anogan", "AnoGANTrainer")])
def test_cli_train_refuses_own_trainers(name, trainer, tmp_path):
    with pytest.raises(ValueError, match=trainer):
        cli.main(_train_args(name, tmp_path, "{}"))


@pytest.mark.parametrize("cmd", ["infer", "eval"])
def test_cli_infer_eval_zoo(cmd, tmp_path, capsys):
    """``infer`` and ``eval`` with ``--quantize off`` take Y-Net-FFC (any
    model whose forward is one tensor); the int8 modes and models with
    other outputs refuse."""
    common = ["--model", "y_net_gen_ffc", "--device", "cpu", "--image-size",
              "32", "--batch-size", "2", "--num-classes", "4",
              "--dtype", "float32", "--model-kwargs",
              '{"init_features": 8}']
    extra = (["--out-dir", str(tmp_path)] if cmd == "infer"
             else ["--num-val", "2"])
    out = cli.main([cmd, *common, *extra])
    if cmd == "infer":
        assert tuple(out.shape) == (2, 32, 32)
        assert np.load(tmp_path / "masks.npy").shape == (2, 32, 32)
    else:
        assert out["confusion"].sum() == 2 * 32 * 32
        assert "pixel_accuracy" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="supports --quantize off"):
        cli.main([cmd, *common, *extra, "--quantize", "int8"])
    with pytest.raises(SystemExit, match="one tensor"):
        cli.main([cmd, "--model", "fouriernet", "--device", "cpu", *extra])


@pytest.mark.parametrize("name", ["anogan", "edgeal", "fouriernet",
                                  "y_net_gen", "y_net_gen_ffc"])
def test_cli_smoke_zoo(name, capsys):
    """``cli smoke`` builds each new model as the JAX CLI does (64x64, one
    channel, 4 classes; AnoGAN with one): its parameter count is the JAX
    model's (``jax.eval_shape`` of the JAX CLI's init)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    cli.main(["smoke", "--model", name, "--num-classes", "4",
              "--device", "cpu"])
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith(name) and " ok " in line
    jm = jax_get_model(name, num_classes=1 if name == "anogan" else 4)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 1)))
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert f"params={n:>12,}" in line
