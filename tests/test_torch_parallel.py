"""The port's parallel runtime (``…_tpu_torch/parallel/``) on the CPU: two
gloo ranks, started once for the module (``readings``), run every
multi-rank check and return their readings; each test asserts on one.
JAX is imported only in the parent (the ranks import this module), for
the comparisons with the JAX package.

* ``halo_exchange``: rows exact at the borders, edges "zero" and
  "replicate";
* ``spatial_shard_infer``: the float U-Net (f=4, 64x48, float32) and the
  int8 oracle, bit-equal to the unsharded port forward;
* ``dp_serve``: the int8 oracle's and the PSRP graph's labels (its
  kernels' plain versions on the CPU) equal to one rank's;
* the data-parallel step (U-Net f=4, 32x32, global batch 4, float32)
  against the one-rank step on the whole batch: relative loss < 1e-6,
  whole-gradient cosine > 0.99999, running statistics within 1e-6; and
  against JAX's ``Trainer`` step on a 2-device mesh of the 8 virtual CPU
  devices (``tests/conftest.py``) from the same weights: loss and running
  statistics within 1e-5, the parameters after Adam within 1e-6 where the
  gradient is clear of Adam's epsilon (``test_torch_train.py``'s regime
  for a float32 step);
* ``cli infer --spatial 2`` (off and int8) in the ranks: masks equal to
  ``--spatial 1``'s, run in the parent;
* ``dryrun_multichip(2, device="cpu")`` in the ranks, and its default
  device, the card, refused where there is none;
* ``infer --spatial 2`` refused for models with global operations;
* the mesh builders in the ranks, and ``distributed_init``'s
  single-process no-op in the parent; ``sliding_window_infer`` against
  JAX's.
"""

import os

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    TrainConfig,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    quantized as tq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
    quantize_unet_psrp,
    unet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    build_unet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel import (
    halo,
    mesh as tmesh,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.dryrun import (
    dryrun_multichip,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.launch import (
    run_ranks,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.serving import (
    dp_serve,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.trainer import (
    Trainer,
    nhwc_logits,
)

NC, F, B, HW = 4, 4, 4, 32
LR = 1e-3  # OptimConfig's default
CLI_ARGS = ["--model", "unet", "--num-classes", "5", "--image-size", "64",
            "--batch-size", "2", "--dtype", "float32", "--model-kwargs",
            '{"init_features": 4}', "--device", "cpu"]


def _cfg(mesh_shape=None):
    return TrainConfig(
        model=ModelConfig(num_classes=NC, kwargs={"init_features": F}),
        data=DataConfig(image_size=(HW, HW), batch_size=B, normalize=False),
        compute_dtype="float32", mesh_shape=mesh_shape)


def _batch():
    rng = np.random.default_rng(7)
    images = rng.standard_normal((B, HW, HW, 1)).astype(np.float32)
    labels = rng.integers(0, NC, (B, HW, HW)).astype(np.int64)
    return torch.from_numpy(images), torch.from_numpy(labels)


def _step(trainer):
    """One step on the whole batch -> (loss, {name: grad}, state dict)."""
    state = trainer.init_state()
    loss = trainer.train_step_fn()(state, *_batch())
    grads = {n: p.grad.clone() for n, p in state.model.named_parameters()}
    return float(loss), grads, {k: v.clone() for k, v in
                                state.model.state_dict().items()}


def _halo_readings(mesh):
    r = mesh.axis_index("space")
    x = (torch.arange(2 * 4 * 3, dtype=torch.float32).reshape(2, 4, 3, 1)
         + 100 * r)
    return {edge: halo.halo_exchange(x, 2, edge=edge, mesh=mesh)
            for edge in ("zero", "replicate")}


def _spatial_readings(mesh):
    model = build_unet(1, 5, init_features=F, seed=1)
    images = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 64, 48, 1)).astype(np.float32))
    with torch.no_grad():
        fwd = lambda m, t: nhwc_logits(m, t, torch.float32)  # noqa: E731
        full = fwd(model, images)
        sharded = halo.spatial_shard_infer(fwd, model, images, mesh)
        layers = tq.fold_unet_bn(model)
        qp = tq.quantize_unet(layers, tq.calibrate_unet(layers, [images]))
        full_q = tq.unet_int8_forward(qp, images)
        sharded_q = halo.spatial_shard_infer(tq.unet_int8_forward, qp,
                                             images, mesh)
    return {"float": (full, sharded), "int8": (full_q, sharded_q)}


def _serving_readings(mesh):
    model = build_unet(1, 5, init_features=16, seed=2)
    images = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 32, 32, 1)).astype(np.float32))
    layers = tq.fold_unet_bn(model)
    taps = tq.calibrate_unet(layers, [images])
    qp = tq.quantize_unet(layers, taps)
    pp = quantize_unet_psrp(layers, taps, 16)
    with torch.no_grad():
        oracle = lambda q, t: tq.unet_int8_forward(q, t).argmax(-1)  # noqa
        psrp = lambda q, t: unet_psrp_forward(q, t, 5)  # noqa: E731
        return {"int8": (oracle(qp, images), dp_serve(oracle, mesh)(qp, images)),
                "psrp": (psrp(pp, images), dp_serve(psrp, mesh)(pp, images))}


def _mesh_readings():
    out = {}
    for name, m in (("1x2", tmesh.create_mesh(1, 2)),
                    ("2x1", tmesh.create_mesh(2, 1)),
                    ("default", tmesh.create_mesh()),
                    ("local", tmesh.local_mesh()),
                    ("hybrid", tmesh.create_hybrid_mesh(space=2))):
        out[name] = (m.shape, m.coords, m.axis_ranks("data"),
                     m.axis_ranks("space"))
    out["init_again"] = tmesh.distributed_init()
    return out


def _rank_checks(out_dirs):
    """Every multi-rank check, on each rank; -> that rank's readings."""
    rank = torch.distributed.get_rank()
    space = tmesh.create_mesh(data=1, space=2)
    data = tmesh.create_mesh(data=2, space=1)
    out = {"halo": _halo_readings(space), "spatial": _spatial_readings(space),
           "serving": _serving_readings(data), "mesh": _mesh_readings()}
    out["dp_step"] = _step(Trainer(_cfg({"data": 2, "space": 1}), "cpu"))
    if rank == 0:
        out["one_rank_step"] = _step(Trainer(_cfg(), "cpu"))
    for quantize, d in out_dirs.items():
        cli.main(["infer", *CLI_ARGS, "--quantize", quantize, "--spatial",
                  "2", "--out-dir", d])
    out["dryrun"] = dryrun_multichip(2, device="cpu")
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    base = tmp_path_factory.mktemp("spatial")
    dirs = {q: str(base / f"s2_{q}") for q in ("off", "int8")}
    ranks = run_ranks(_rank_checks, 2, dirs, backend="gloo")
    return {"ranks": ranks, "dirs": dirs, "base": base}


def test_halo_exchange_rows_at_the_borders(readings):
    x = [np.arange(24, dtype=np.float32).reshape(2, 4, 3, 1) + 100 * r
         for r in (0, 1)]
    for r, rank in enumerate(readings["ranks"]):
        for edge, got in rank["halo"].items():
            if edge == "zero":
                top = np.zeros_like(x[0][:, :2]) if r == 0 else x[0][:, -2:]
                bot = x[1][:, :2] if r == 0 else np.zeros_like(x[0][:, :2])
            else:
                top = np.repeat(x[0][:, :1], 2, 1) if r == 0 else \
                    x[0][:, -2:]
                bot = x[1][:, :2] if r == 0 else np.repeat(x[1][:, -1:], 2,
                                                           1)
            want = np.concatenate([top, x[r], bot], axis=1)
            np.testing.assert_array_equal(got.numpy(), want, f"{r} {edge}")


@pytest.mark.parametrize("graph", ["float", "int8"])
def test_spatial_shard_infer_bit_equal(readings, graph):
    for rank in readings["ranks"]:
        full, sharded = rank["spatial"][graph]
        assert sharded.shape == full.shape == (2, 64, 48, 5)
        assert torch.equal(sharded, full), graph


@pytest.mark.parametrize("graph", ["int8", "psrp"])
def test_dp_serve_equals_one_rank(readings, graph):
    for rank in readings["ranks"]:
        one, served = rank["serving"][graph]
        assert served.shape == (2, 32, 32)
        assert torch.equal(served, one), graph


def test_dp_step_equals_the_one_rank_step(readings):
    r0, r1 = readings["ranks"]
    loss, grads, state = r0["dp_step"]
    want_loss, want_grads, want_state = r0["one_rank_step"]
    # both ranks took the same step
    assert r1["dp_step"][0] == loss
    for k in state:
        assert torch.equal(r1["dp_step"][2][k], state[k]), k
    assert abs(loss - want_loss) < 1e-6 * abs(want_loss)
    g = torch.cat([grads[k].reshape(-1) for k in want_grads]).double()
    w = torch.cat([want_grads[k].reshape(-1) for k in want_grads]).double()
    assert float(g @ w / (g.norm() * w.norm())) > 0.99999
    for k in state:
        if "running" in k:
            assert (state[k] - want_state[k]).abs().max() <= 1e-6, k


def test_dp_step_matches_jax_trainer_on_two_devices(readings):
    import jax
    import jax.numpy as jnp

    from retinal_oct_image_segmentation_via_deep_learning_tpu import (
        config as jcfg,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.parallel.mesh import (
        create_mesh as jcreate_mesh,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
        train_state as jts,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training.trainer import (
        Trainer as JTrainer,
        make_train_step as jmake_train_step,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_variables_from_state_dict,
    )

    jt = JTrainer(jcfg.TrainConfig(
        model=jcfg.ModelConfig(num_classes=NC, kwargs={"init_features": F}),
        data=jcfg.DataConfig(image_size=(HW, HW), batch_size=B,
                             normalize=False),
        compute_dtype="float32"),
        mesh=jcreate_mesh(data=2, devices=jax.devices()[:2]))
    start = Trainer(_cfg(), "cpu").model.state_dict()
    v = unet_variables_from_state_dict(start)
    jstate = jax.device_put(jts.create_train_state(jt.model, v,
                                                   jcfg.OptimConfig()),
                            jt._rep)
    images, labels = _batch()
    xs, ys = jt._shard(jnp.asarray(images.numpy()),
                       jnp.asarray(labels.numpy().astype(np.int32)))
    jstate, jloss = jax.jit(jmake_train_step(jt.model, jt.loss_fn))(
        jstate, xs, ys)
    loss, grads, state = readings["ranks"][0]["dp_step"]
    assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss))
    want = unet_variables_from_state_dict(state)
    got_p = jax.tree.leaves(jax.device_get(jstate.params))
    want_p = jax.tree.leaves(want["params"])
    before = jax.tree.leaves(v["params"])
    for j, p, p0 in zip(got_p, want_p, before):
        j, p, p0 = np.asarray(j), np.asarray(p), np.asarray(p0)
        # Adam's first step moves a weight by lr * g / (|g| + eps): where
        # |g| is within ~100 eps the move depends on the gradient's last
        # bits (a float32 reading, not the step), so those are skipped
        moved = np.abs(p - p0) > 0.99 * LR
        np.testing.assert_allclose(j[moved], p[moved], rtol=0, atol=1e-6)
    for j, p in zip(jax.tree.leaves(jax.device_get(jstate.batch_stats)),
                    jax.tree.leaves(want["batch_stats"])):
        np.testing.assert_allclose(np.asarray(j), np.asarray(p), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_infer_spatial_2_writes_the_masks_of_spatial_1(readings, quantize):
    one = str(readings["base"] / f"s1_{quantize}")
    cli.main(["infer", *CLI_ARGS, "--quantize", quantize, "--out-dir", one])
    want = np.load(os.path.join(one, "masks.npy"))
    got = np.load(os.path.join(readings["dirs"][quantize], "masks.npy"))
    assert got.shape == (2, 64, 64)
    np.testing.assert_array_equal(got, want)


def test_dryrun_multichip_two_ranks(readings):
    for rank in readings["ranks"]:
        d = rank["dryrun"]
        assert (d["device"], d["backend"]) == ("cpu", "gloo")
        assert np.isfinite(d["dp_loss"])
        assert d["sp_out"] == (1, 64, 32, 4)
        assert d["sp_int8_out"] == (1, 64, 32, 4)
        assert d["dp_serve_out"] == (2, 32, 32)
        assert d["dp_int4_out"] == (2, 32, 32)
        assert d["dp_int4_local_equal"]
    assert readings["ranks"][0]["dryrun"]["dp_loss"] == \
        readings["ranks"][1]["dryrun"]["dp_loss"]


def test_dryrun_multichip_asks_for_the_cpu(monkeypatch):
    """Its default device is the card: with none it raises, naming how to
    ask for the CPU, and starts no rank."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2)


@pytest.mark.parametrize("model", ["y_net_gen_ffc", "lightreseg",
                                   "retifluidnet", "relaynet"])
def test_infer_spatial_refuses_models_with_global_operations(model):
    """Only convs exchange halo rows: a model with an FFT, global pooling
    or whole-image attention would give other masks sharded, so
    ``--spatial`` refuses it before it starts a rank."""
    argv = [a if a != "unet" else model for a in CLI_ARGS]
    with pytest.raises(SystemExit, match="--spatial shards unet only"):
        cli.main(["infer", *argv, "--quantize", "off", "--spatial", "2",
                  "--out-dir", "unused"])


def test_mesh_builders_on_two_ranks(readings):
    for r, rank in enumerate(readings["ranks"]):
        m = rank["mesh"]
        assert m["1x2"] == ({"data": 1, "space": 2}, (0, r), [r], [0, 1])
        assert m["2x1"] == ({"data": 2, "space": 1}, (r, 0), [0, 1], [r])
        assert m["default"] == m["local"] == m["2x1"]
        assert m["hybrid"] == m["1x2"]
        assert m["init_again"] is True


def test_single_process_mesh_and_distributed_init():
    assert tmesh.distributed_init() is False
    m = tmesh.create_mesh()
    assert m.shape == {"data": 1, "space": 1} and m.coords == (0, 0)
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.create_mesh(data=2)
    with pytest.raises(ValueError, match="axis"):
        m.axis_index("model")
    with pytest.raises(ValueError, match="mesh"):
        with halo.spatial_partitioning():
            pass


def test_trainer_refusals():
    with pytest.raises(ValueError, match="space"):
        Trainer(_cfg({"data": 1, "space": 1}), "cpu",
                mesh=tmesh.Mesh(np.zeros((1, 2), int), {}, None))
    tt = Trainer(_cfg(), "cpu")
    tt.cfg = TrainConfig(model=ModelConfig(num_classes=NC), packed_train=True)
    tt._group, tt.mesh = object(), tmesh.create_mesh()
    with pytest.raises(ValueError, match="one device"):
        tt.train_step_fn()


def test_sliding_window_infer_matches_jax():
    import jax.numpy as jnp

    from retinal_oct_image_segmentation_via_deep_learning_tpu.parallel.halo import (
        sliding_window_infer as jsliding,
    )

    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 40, 8, 1)).astype(np.float32)
    w = rng.standard_normal((3, 3, 1, 3)).astype(np.float32)

    def jfn(w, t):
        import jax

        return jax.lax.conv_general_dilated(
            t, w, (1, 1), [(1, 1), (1, 1)],
            dimension_numbers=("NHWC", "HWIO", "NHWC"))

    def tfn(w, t):
        y = torch.nn.functional.conv2d(t.permute(0, 3, 1, 2),
                                       w.permute(3, 2, 0, 1), padding=1)
        return y.permute(0, 2, 3, 1)

    want = np.asarray(jsliding(jfn, jnp.asarray(w), jnp.asarray(x), tile=16,
                               overlap=4))
    got = halo.sliding_window_infer(tfn, torch.from_numpy(w),
                                    torch.from_numpy(x), tile=16, overlap=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    small = halo.sliding_window_infer(tfn, torch.from_numpy(w),
                                      torch.from_numpy(x), tile=64)
    assert torch.equal(small, tfn(torch.from_numpy(w), torch.from_numpy(x)))
