"""The port's leftover utilities against the JAX package, on the CPU:
``config.flat_update``, ``registry.register_model`` / ``register_lazy``,
``utils/dtype.DTypePolicy``, ``utils/debug`` (``nan_debugging`` raises
naming the op, forward and backward, and not with ``enabled=False``;
``find_nonfinite``, ``assert_finite``), ``utils/profiling`` (``trace``,
``annotate``, ``sync``, ``count_params``) and the generic step's
``remat="full"`` / ``OCTSEG_TRAIN_REMAT`` (U-Net f=4, 32x32, batch 2,
float32): loss, gradients and running statistics bit-equal to the plain
step's, the statistics moved once.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

from retinal_oct_image_segmentation_via_deep_learning_tpu import (
    config as jconfig,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu import (
    registry as jregistry,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.utils import (
    dtype as jdtype,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.utils import (
    profiling as jprofiling,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
    config,
    registry,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    UNet,
    build_unet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    losses,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
    create_train_state,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
    make_train_step,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils import (
    debug,
    dtype,
    profiling,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_variables_from_state_dict,
)


def test_flat_update_matches_jax():
    updates = {"optim.learning_rate": 3e-4, "model.kwargs": {"f": 8},
               "data.batch_size": 2, "num_epochs": 3,
               "mesh_shape": {"data": 2, "space": 1}}
    got = config.flat_update(config.TrainConfig(), updates)
    want = jconfig.flat_update(jconfig.TrainConfig(), updates)
    for key, value in updates.items():
        node, jnode = got, want
        for part in key.split("."):
            node, jnode = getattr(node, part), getattr(jnode, part)
        assert node == jnode == value, key
    assert config.TrainConfig().optim.learning_rate == 1e-3  # a copy
    assert config.TrainConfig().mesh_shape is \
        jconfig.TrainConfig().mesh_shape is None
    with pytest.raises(TypeError):
        config.flat_update(config.TrainConfig(), {"optim.nope": 1})


def test_registry_register_model_and_lazy(monkeypatch):
    monkeypatch.setattr(registry, "_MODELS", dict(registry._MODELS))
    monkeypatch.setattr(registry, "_LAZY", dict(registry._LAZY))

    @registry.register_model("tiny_unet")
    def tiny(**kw):
        return build_unet(init_features=4, **kw)

    assert registry.register_model("tiny2", tiny) is tiny
    registry.register_lazy("lazy_unet", "unet", "build_unet")
    assert {"tiny_unet", "tiny2", "lazy_unet"} <= set(registry.list_models())
    assert isinstance(registry.get_model("tiny_unet", num_classes=3), UNet)
    m = registry.get_model("lazy_unet", num_classes=3, init_features=4)
    assert isinstance(m, UNet) and m.conv.out_channels == 3
    with pytest.raises(ValueError, match="lazy_unet.*tiny2"):
        registry.get_model("nope")
    # JAX's registry has the same two entry points
    assert callable(jregistry.register_model)
    assert callable(jregistry.register_lazy)


@pytest.mark.parametrize("name", ["float32", "fp32", "bfloat16", "bf16",
                                  "float16"])
def test_dtype_policy_matches_jax(name):
    got, want = dtype.DTypePolicy.create(name), jdtype.DTypePolicy.create(
        name)
    assert got.param_dtype == torch.float32
    assert str(got.compute_dtype).split(".")[-1] == \
        np.dtype(want.compute_dtype).name
    assert dataclasses.is_dataclass(got) and dtype.DTypePolicy() == \
        dtype.DTypePolicy(torch.float32, torch.float32)


def test_nan_debugging_names_the_op():
    a = torch.tensor([0.0, 1.0], requires_grad=True)
    with debug.nan_debugging():
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor([-1.0]))
        # finite forward, NaN in the backward (0 * inf of sqrt at 0)
        z = torch.where(a > 0, torch.sqrt(a), torch.zeros_like(a)).sum()
        with pytest.raises(FloatingPointError, match="aten"):
            z.backward()
    with debug.nan_debugging(enabled=False):
        assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()
    assert torch.isnan(torch.log(torch.tensor([-1.0]))).all()


def test_find_nonfinite_and_assert_finite():
    m = UNet(1, 3, 4)
    assert debug.find_nonfinite(m) == []
    with torch.no_grad():
        m.encoder1.enc1conv1.weight[0, 0, 0, 0] = float("inf")
        m.decoder1.dec1norm2.running_var[1] = float("nan")
    assert debug.find_nonfinite(m) == ["encoder1.enc1conv1.weight",
                                       "decoder1.dec1norm2.running_var"]
    tree = {"a": [torch.ones(2), torch.tensor([1.0, float("nan")])],
            "b": torch.arange(3)}
    assert debug.find_nonfinite(tree) == ["a.1"]
    with pytest.raises(FloatingPointError, match="state: a.1"):
        debug.assert_finite(tree, "state")
    debug.assert_finite({"x": torch.zeros(2)})


def test_profiling_helpers(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("port_region"):
            torch.ones(4) @ torch.ones(4)
    traces = list(tmp_path.iterdir())
    assert len(traces) == 1 and "port_region" in traces[0].read_text()
    t = {"x": torch.ones(2)}
    assert profiling.sync(t) is t
    m = UNet(1, 3, 4)
    v = unet_variables_from_state_dict(m.state_dict())
    assert profiling.count_params(m) == jprofiling.count_params(
        v["params"]) == profiling.count_params(dict(m.named_parameters()))
    assert jax.devices()  # JAX's own helpers stay JAX's


def _remat_step(remat, env=None):
    model = build_unet(1, 4, init_features=4, seed=2).train()
    state = create_train_state(model, config.OptimConfig())
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.standard_normal((2, 32, 32, 1)).astype(
        np.float32))
    labels = torch.from_numpy(rng.integers(0, 4, (2, 32, 32)))
    before = {k: v.clone() for k, v in model.state_dict().items()
              if "running" in k}
    old = os.environ.pop("OCTSEG_TRAIN_REMAT", None)
    if env:
        os.environ["OCTSEG_TRAIN_REMAT"] = env
    try:
        step = make_train_step(losses.dice_ce_loss, dtype=torch.float32,
                               remat=remat)
    finally:
        os.environ.pop("OCTSEG_TRAIN_REMAT", None)
        if old is not None:
            os.environ["OCTSEG_TRAIN_REMAT"] = old
    calls = []
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(lambda *a: calls.append(1))
    loss = step(state, images, labels)
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    return loss, grads, model.state_dict(), before, len(calls)


@pytest.mark.parametrize("how", ["argument", "environment"])
def test_remat_full_equals_the_plain_step(how):
    loss, grads, sd, before, calls = _remat_step(None)
    r = _remat_step("full") if how == "argument" else \
        _remat_step(None, env="full")
    # the 18 BatchNorms ran again in the backward's recompute
    assert (calls, r[4]) == (18, 36)
    assert torch.equal(r[0], loss)
    for n in grads:
        assert torch.equal(r[1][n], grads[n]), n
    for k in before:
        # moved once: the recompute left them alone
        assert torch.equal(r[2][k], sd[k]), k
        assert not torch.equal(sd[k], before[k]), k


def test_remat_rejects_unknown_values():
    with pytest.raises(ValueError, match="remat"):
        make_train_step(losses.dice_ce_loss, remat="blocks")
