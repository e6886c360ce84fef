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
  whole-gradient cosine > 0.99999, running statistics within 1e-6,
  the largest change of a gradient tensor's norm < 1e-4; and against
  JAX's ``Trainer`` step on a 2-device mesh of the 8 virtual CPU
  devices (``tests/conftest.py``) from the same weights: loss and running
  statistics within 1e-5, the parameters after Adam within 1e-6 where the
  gradient is clear of Adam's epsilon (``test_torch_train.py``'s regime
  for a float32 step);
* the data-parallel packed U-Net step (``make_packed_train_step(mesh=)``;
  ``test_torch_train.py``'s packed case: f=8, 7 classes, 32x32, bf16, here
  at global batch 4) with the unfused loss, the fused loss (K8/K9's plain
  versions), ``remat=True`` and ``deep=mid="kernel"``, against the
  one-rank packed step on the whole batch (``PACKED_GATE``): relative
  loss < 1e-5, whole-gradient cosine > 0.9999, a gradient tensor's norm
  within 2e-2, running statistics within 1e-5, both ranks equal, remat
  bit-equal to no remat; a gradient scaled by 2 or 0.5 fails that gate.
  Against JAX's packed step and its gradients, jitted once over a batch
  sharded on a 2-device mesh: the gradients at ``JAX_GRAD_GATE``, and
  after Adam loss within 2%, parameters rtol 0.1 / atol 2e-3, BN
  statistics rtol 0.05 / atol 1e-3 (``test_torch_train.py``'s packed
  tolerances). K8's statistics, and K6's sums, left unreduced must each
  fail both the one-rank and the JAX gradient comparison; the packed
  ``Trainer`` step on the data mesh;
* ``cli train --packed`` in the ranks (their group's ``local_mesh``): equal
  state on both, one checkpoint, written by rank 0 alone, which ``eval
  --checkpoint`` reads in the parent;
* ``cli infer --spatial 2`` (off and int8) in the ranks: masks equal to
  ``--spatial 1``'s, run in the parent, and to a pinned digest; the
  trainer its ranks build on no data mesh;
* ``dryrun_multichip(2, device="cpu")`` in the ranks, and its default
  device, the card, refused where there is none;
* ``infer --spatial 2`` refused for models with global operations;
* the mesh builders in the ranks, and ``distributed_init``'s
  single-process no-op in the parent; ``sliding_window_infer`` against
  JAX's.
"""

import dataclasses
import glob
import hashlib
import os
from unittest import mock

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.config import (
    DataConfig,
    ModelConfig,
    OptimConfig,
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
    UNet,
    build_unet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    dice_ce,
    fused_bn,
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
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    checkpoint as tckpt,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    losses as tlosses,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training import (
    packed_unet as tpacked,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.train_state import (
    TrainState,
    create_train_state,
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


# test_torch_train.py's packed case at global batch 4
PF, PNC, PHW, PB = 8, 7, 32, 4
PACKED = {"unfused": {}, "fused": {"fused_loss": True},
          "remat": {"remat": True},
          "kernel": {"deep": "kernel", "mid": "kernel"}}
# against the one-rank step: relative loss, whole-gradient cosine, the
# largest |norm ratio - 1| of a gradient tensor (the sound steps read at
# most 4.9e-3, "kernel"; the faults below 0.58 and 1.02, a gradient off by
# the number of ranks 1 or 0.5) and running statistics
PACKED_GATE = {"loss": 1e-5, "cosine": 0.9999, "norm": 2e-2, "stats": 1e-5}
# against JAX's gradients of the packed loss on the sharded batch, both
# sides bf16: relative loss, whole-gradient cosine and the largest |norm
# ratio - 1| of a gradient leaf. The sound steps read 2.0e-05 / 0.958 /
# 0.257, the last at Conv_0/bias, whose gradient JAX reduces in bf16 (the
# bias is added to the bf16 logits); K8 unreduced reads 4.7e-04 / 0.958 /
# 1.51 and K6 unreduced 1.3e-04 / 0.738 / 0.570: the limits sit between.
JAX_GRAD_GATE = {"loss": 6e-5, "cosine": 0.9, "norm": 0.4}
# planted faults: a step with each must fail PACKED_GATE against one rank
# and JAX_GRAD_GATE against JAX
UNREDUCED = {
    "K8 statistics unreduced": ({"fused_loss": True}, mock.patch.object(
        dice_ce, "_global", lambda stats, group: stats)),
    "K6 sums unreduced": ({}, mock.patch.object(
        fused_bn, "_global", lambda sums, m, group: (sums, m))),
}
TRAIN_ARGS = ["train", "--device", "cpu", "--image-size", "32",
              "--batch-size", "4", "--num-train", "8", "--num-val", "2",
              "--epochs", "1", "--num-classes", "5", "--model-kwargs",
              '{"init_features": 4}', "--packed"]
# sha256 of the masks ``infer --spatial 2`` writes with CLI_ARGS, pinned
# (the same for both modes: the random-init U-Net at f=4 gives class 4
# everywhere)
SPATIAL_MASKS_SHA256 = {
    q: "3f1482487a946996cee4eaddb7f29b2faa49c10bb32c143dcf0f56f25cceccaa"
    for q in ("off", "int8")}


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


def _packed_batch():
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.standard_normal((PB, PHW, PHW, 1)),
                     dtype=torch.bfloat16)
    return x, torch.from_numpy(rng.integers(0, PNC, (PB, PHW, PHW)))


def _packed_model():
    return UNet(1, PNC, PF, generator=torch.Generator().manual_seed(0))


def _packed_step(mesh, **kw):
    """One packed step (Adam 1e-3, dice_ce) from the seeded U-Net on the
    global batch -> (loss, {name: gradient}, state dict)."""
    model = _packed_model()
    state = create_train_state(model, OptimConfig())
    step = tpacked.make_packed_train_step(tlosses.dice_ce_loss, mesh=mesh,
                                          **kw)
    loss = float(step(state, *_packed_batch()))
    return (loss, {n: p.grad.clone() for n, p in model.named_parameters()},
            {k: v.clone() for k, v in model.state_dict().items()})


def _packed_readings(data):
    """The packed step on the data mesh (each case and planted fault) and,
    on rank 0, on one rank; the packed ``Trainer`` step on the mesh."""
    out = {"dp": {c: _packed_step(data, **kw) for c, kw in PACKED.items()},
           "fault": {}}
    for label, (kw, fault) in UNREDUCED.items():
        with fault:
            out["fault"][label] = _packed_step(data, **kw)
    if torch.distributed.get_rank() == 0:
        out["one"] = {c: _packed_step(None, **kw) for c, kw in PACKED.items()}
    cfg = TrainConfig(
        model=ModelConfig(num_classes=PNC, kwargs={"init_features": PF}),
        data=DataConfig(image_size=(PHW, PHW), batch_size=PB),
        packed_train=True)
    shapes = {"trainer": {"data": 2, "space": 1}}
    if torch.distributed.get_rank() == 0:
        shapes["one_trainer"] = None
    for key, shape in shapes.items():
        trainer = Trainer(dataclasses.replace(cfg, mesh_shape=shape), "cpu")
        state = trainer.init_state()
        loss = float(trainer.train_step_fn()(state, *_packed_batch()))
        out[key] = (loss, state.step, {k: v.clone() for k, v in
                                       state.model.state_dict().items()})
    return out


def _train_readings(ckpt_dir):
    """``cli train --packed`` inside the ranks' group: its state, the ranks
    that saved a checkpoint, and the trainer the infer path builds."""
    saved = []
    save = tckpt.CheckpointManager.save

    def spy(self, *args, **kwargs):
        saved.append(torch.distributed.get_rank())
        return save(self, *args, **kwargs)

    with mock.patch.object(tckpt.CheckpointManager, "save", spy):
        state = cli.main([*TRAIN_ARGS, "--checkpoint-dir", ckpt_dir,
                          "--log-file", os.path.join(ckpt_dir, "log.jsonl")])
    infer, _ = cli.build_eval_trainer(cli.parser().parse_args(
        ["infer", *CLI_ARGS]))
    return {"state": {k: v.clone() for k, v in
                      state.model.state_dict().items()},
            "step": state.step, "saved": saved,
            "infer_mesh": (infer.mesh, infer._group)}


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


def _rank_checks(out_dirs, ckpt_dir):
    """Every multi-rank check, on each rank; -> that rank's readings."""
    rank = torch.distributed.get_rank()
    space = tmesh.create_mesh(data=1, space=2)
    data = tmesh.create_mesh(data=2, space=1)
    out = {"halo": _halo_readings(space), "spatial": _spatial_readings(space),
           "serving": _serving_readings(data), "mesh": _mesh_readings()}
    out["dp_step"] = _step(Trainer(_cfg({"data": 2, "space": 1}), "cpu"))
    if rank == 0:
        out["one_rank_step"] = _step(Trainer(_cfg(), "cpu"))
    out["packed"] = _packed_readings(data)
    out["train"] = _train_readings(ckpt_dir)
    for quantize, d in out_dirs.items():
        cli.main(["infer", *CLI_ARGS, "--quantize", quantize, "--spatial",
                  "2", "--out-dir", d])
    out["dryrun"] = dryrun_multichip(2, device="cpu")
    return out


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    base = tmp_path_factory.mktemp("spatial")
    dirs = {q: str(base / f"s2_{q}") for q in ("off", "int8")}
    ckpt = str(base / "ckpt")
    ranks = run_ranks(_rank_checks, 2, dirs, ckpt, backend="gloo")
    return {"ranks": ranks, "dirs": dirs, "base": base, "ckpt": ckpt}


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
    # a gradient off by the number of ranks reads 1 or 0.5 here
    assert _norm_change(grads, want_grads) < 1e-4
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


def _norm_change(got, want):
    """The largest |norm ratio - 1| over the gradient tensors of two
    {name: gradient} maps."""
    return max(abs(float(got[k].double().norm() / want[k].double().norm())
                   - 1) for k in want)


def _agreement(got, want):
    """(relative loss, whole-gradient cosine, largest change of a gradient
    tensor's norm, largest running-statistic difference) of a step against
    another."""
    g = torch.cat([got[1][k].reshape(-1) for k in want[1]]).double()
    w = torch.cat([want[1][k].reshape(-1) for k in want[1]]).double()
    return (abs(got[0] - want[0]) / abs(want[0]),
            float(g @ w / (g.norm() * w.norm())),
            _norm_change(got[1], want[1]),
            max(float((got[2][k] - want[2][k]).abs().max())
                for k in want[2] if "running" in k))


def _passes(agree):
    return agree[0] < PACKED_GATE["loss"] and \
        agree[1] > PACKED_GATE["cosine"] and \
        agree[2] < PACKED_GATE["norm"] and agree[3] <= PACKED_GATE["stats"]


def _reading(agree):
    return (f"relative loss {agree[0]:.3e}, cosine {agree[1]:.9f}, norm "
            f"change {agree[2]:.3e}, running statistics {agree[3]:.3e}")


@pytest.mark.parametrize("case", list(PACKED))
def test_packed_dp_step_equals_the_one_rank_step(readings, case):
    r0, r1 = (r["packed"] for r in readings["ranks"])
    got = r0["dp"][case]
    # both ranks took the same step
    assert r1["dp"][case][0] == got[0]
    for k in got[2]:
        assert torch.equal(r1["dp"][case][2][k], got[2][k]), k
    agree = _agreement(got, r0["one"][case])
    print(f"{case}: {_reading(agree)}")
    assert _passes(agree), agree


@pytest.mark.parametrize("scale", [2.0, 0.5])
def test_packed_gate_refuses_a_gradient_off_in_scale(readings, scale):
    """A gradient summed where it should be averaged, or averaged where it
    should be summed, over the two ranks: the cosine and Adam's step do
    not see it; the norm gate does."""
    r0 = readings["ranks"][0]["packed"]
    loss, grads, state = r0["dp"]["unfused"]
    agree = _agreement((loss, {k: scale * g for k, g in grads.items()},
                        state), r0["one"]["unfused"])
    assert agree[1] > PACKED_GATE["cosine"]
    assert not _passes(agree), (scale, agree)


def test_packed_dp_remat_is_bit_equal_and_moves_stats_once(readings):
    """Under the group the recompute's K6 sums are all-reduced again, in
    the same order on both ranks: the remat step equals the plain one bit
    for bit, its running statistics moved once."""
    for rank in readings["ranks"]:
        plain, remat = rank["packed"]["dp"]["unfused"], \
            rank["packed"]["dp"]["remat"]
        assert remat[0] == plain[0]
        for k in plain[1]:
            assert torch.equal(remat[1][k], plain[1][k]), k
        for k in plain[2]:
            assert torch.equal(remat[2][k], plain[2][k]), k


@pytest.mark.parametrize("fault", list(UNREDUCED))
def test_packed_dp_step_refuses_an_unreduced_sum(readings, fault):
    r0 = readings["ranks"][0]["packed"]
    kw = UNREDUCED[fault][0]
    case = "fused" if kw else "unfused"
    agree = _agreement(r0["fault"][fault], r0["one"][case])
    print(f"{fault}: {_reading(agree)}")
    assert not _passes(agree), (fault, agree)


def _flat(tree, prefix=""):
    """Nested dicts -> {"a/b": leaf as float32 numpy}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def jax_packed_step():
    """JAX's packed step (Adam 1e-3, dice_ce) and its gradients, jitted
    once over the global batch sharded on a 2-device mesh, from the port's
    seeded weights -> loss and the flattened gradients, and parameters and
    batch statistics after the step."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec

    from retinal_oct_image_segmentation_via_deep_learning_tpu.parallel.mesh import (
        create_mesh as jcreate_mesh,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
        losses as jlosses,
        packed_unet as jpacked,
        train_state as jts,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_variables_from_state_dict,
    )

    mesh = jcreate_mesh(data=2, devices=jax.devices()[:2])
    v = unet_variables_from_state_dict(_packed_model().state_dict())
    state = jax.device_put(jts.TrainState.create(
        apply_fn=None, params=v["params"], batch_stats=v["batch_stats"],
        tx=optax.adam(1e-3)), NamedSharding(mesh, PartitionSpec()))
    x, y = _packed_batch()
    put = lambda a: jax.device_put(a, NamedSharding(  # noqa: E731
        mesh, PartitionSpec("data", *([None] * (a.ndim - 1)))))
    step = jpacked.make_packed_train_step(jlosses.dice_ce_loss)

    def step_and_grads(state, x, y):
        def loss_of(params):
            logits, _ = jpacked.packed_unet_apply(
                {"params": params, "batch_stats": state.batch_stats}, x)
            return jlosses.dice_ce_loss(logits, y, None)

        new, loss = step(state, x, y)
        return new, loss, jax.grad(loss_of)(state.params)

    new, loss, grads = jax.jit(step_and_grads)(
        state, put(jnp.asarray(x.float().numpy(), jnp.bfloat16)),
        put(jnp.asarray(y.numpy().astype(np.int32))))
    return {"loss": float(loss), "grads": _flat(jax.device_get(grads)),
            "params": _flat(new.params),
            "batch_stats": _flat(new.batch_stats)}


def _jax_grad_agreement(step, want):
    """(relative loss, whole-gradient cosine, largest |norm ratio - 1| of a
    leaf) of a port step's gradients against JAX's, in JAX's layout."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_variables_from_state_dict,
    )

    tree = {**_packed_model().state_dict(), **step[1]}
    got = _flat(unet_variables_from_state_dict(tree)["params"])
    ref = want["grads"]
    assert got.keys() == ref.keys()
    g = np.concatenate([got[k].ravel() for k in ref]).astype(np.float64)
    w = np.concatenate([ref[k].ravel() for k in ref]).astype(np.float64)
    norm = max(abs(np.linalg.norm(got[k].astype(np.float64))
                   / np.linalg.norm(ref[k].astype(np.float64)) - 1)
               for k in ref)
    return (abs(step[0] - want["loss"]) / abs(want["loss"]),
            float(g @ w / (np.linalg.norm(g) * np.linalg.norm(w))),
            float(norm))


def _jax_grad_passes(agree):
    return agree[0] < JAX_GRAD_GATE["loss"] and \
        agree[1] > JAX_GRAD_GATE["cosine"] and \
        agree[2] < JAX_GRAD_GATE["norm"]


@pytest.mark.parametrize("case", list(PACKED))
def test_packed_dp_step_matches_jax_on_two_devices(readings,
                                                   jax_packed_step, case):
    """The gradients at ``JAX_GRAD_GATE``; the step after Adam at
    ``test_torch_train.py``'s packed tolerances (JAX's fused loss takes its
    XLA twin at W < 128, so both port losses meet its one step)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_variables_from_state_dict,
    )

    step = readings["ranks"][0]["packed"]["dp"][case]
    loss, _, state = step
    want = jax_packed_step
    agree = _jax_grad_agreement(step, want)
    print(f"{case} against JAX: relative loss {agree[0]:.3e}, cosine "
          f"{agree[1]:.9f}, norm change {agree[2]:.3e}")
    assert _jax_grad_passes(agree), agree
    assert abs(loss - want["loss"]) < 0.02 * max(1.0, want["loss"])
    got = unet_variables_from_state_dict(state)
    got_p, got_s = _flat(got["params"]), _flat(got["batch_stats"])
    assert got_p.keys() == want["params"].keys()
    for path, leaf in want["params"].items():
        np.testing.assert_allclose(got_p[path], leaf, rtol=0.1, atol=2e-3,
                                   err_msg=path)
    for path, leaf in want["batch_stats"].items():
        np.testing.assert_allclose(got_s[path], leaf, rtol=0.05, atol=1e-3,
                                   err_msg=path)


@pytest.mark.parametrize("fault", list(UNREDUCED))
def test_packed_dp_fault_fails_the_jax_comparison(readings, jax_packed_step,
                                                  fault):
    agree = _jax_grad_agreement(readings["ranks"][0]["packed"]["fault"][fault],
                                jax_packed_step)
    print(f"{fault} against JAX: relative loss {agree[0]:.3e}, cosine "
          f"{agree[1]:.9f}, norm change {agree[2]:.3e}")
    assert not _jax_grad_passes(agree), (fault, agree)


def test_cli_train_in_two_ranks_trains_one_model(readings):
    """``train --packed`` inside the ranks' group trains over its data
    axis: the ranks end equal, rank 0 alone saves, the one checkpoint is
    what ``eval --checkpoint`` reads."""
    r0, r1 = (r["train"] for r in readings["ranks"])
    assert r0["step"] == r1["step"] == 2  # 8 B-scans at a global batch of 4
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k
    assert (r0["saved"], r1["saved"]) == ([0], [])
    files = sorted(glob.glob(os.path.join(readings["ckpt"], "ckpt_*.pt")))
    assert [os.path.basename(f) for f in files] == ["ckpt_0.pt"]
    with open(os.path.join(readings["ckpt"], "log.jsonl")) as f:
        assert len(f.read().splitlines()) == 1  # rank 0's one epoch
    argv = ["eval", "--device", "cpu", "--model", "unet", "--num-classes",
            "5", "--image-size", "32", "--batch-size", "2", "--num-val", "2",
            "--model-kwargs", '{"init_features": 4}', "--checkpoint",
            files[0]]
    trainer, _ = cli.build_eval_trainer(cli.parser().parse_args(argv))
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, r0["state"][k]), k
    m = cli.main(argv)
    assert int(m["confusion"].sum()) == 2 * 32 * 32


def test_cli_train_starts_a_rank_a_card(monkeypatch):
    """``train --device cuda`` on a host of k > 1 cards starts k ranks over
    NCCL, as JAX's ``Trainer`` takes every local chip, and returns rank 0's
    train state on the host; a named card, the CPU or one card train here;
    a batch the cards do not divide exits before any rank starts."""
    started = []
    rank0 = Trainer(_cfg(), "cpu").init_state()
    rank0.step = 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(cli, "run_ranks", lambda fn, n, args, backend: (
        started.append((fn, n, backend))
        or [(_cfg(), rank0.state_dict()), None]))
    args = lambda *a: cli.parser().parse_args(["train", *a])  # noqa: E731
    for cards, argv, ranks in ((4, [], 4), (2, ["--device", "cuda"], 2),
                               (4, ["--device", "cuda:1"], 1),
                               (4, ["--device", "cpu"], 1), (1, [], 1)):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert cli._train_ranks(args(*argv)) == ranks, (cards, argv)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    # rank 0's state comes back as the TrainState one card returns
    state = cli.cmd_train(args("--batch-size", "4"))
    assert started == [(cli._train_rank, 2, "nccl")]
    assert isinstance(state, TrainState) and state.step == 3
    for k, v in rank0.model.state_dict().items():
        assert torch.equal(state.model.state_dict()[k], v), k
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    with pytest.raises(SystemExit, match="multiple of 3"):
        cli.cmd_train(args("--batch-size", "8"))
    assert len(started) == 1


@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_infer_spatial_2_writes_the_masks_of_spatial_1(readings, quantize):
    one = str(readings["base"] / f"s1_{quantize}")
    cli.main(["infer", *CLI_ARGS, "--quantize", quantize, "--out-dir", one])
    want = np.load(os.path.join(one, "masks.npy"))
    got = np.load(os.path.join(readings["dirs"][quantize], "masks.npy"))
    assert got.shape == (2, 64, 64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_infer_spatial_2_keeps_its_space_mesh(readings, quantize):
    """``train`` takes the data mesh of a process group; ``infer --spatial
    2``'s ranks, in a process group too, keep their space mesh: the trainer
    they build has no data mesh, and the masks keep their pinned digest."""
    for rank in readings["ranks"]:
        assert rank["train"]["infer_mesh"] == (None, None)
    masks = np.load(os.path.join(readings["dirs"][quantize], "masks.npy"))
    assert hashlib.sha256(masks.tobytes()).hexdigest() == \
        SPATIAL_MASKS_SHA256[quantize]


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


def test_trainer_refusals(readings):
    """A space axis is refused; the packed step trains under a data mesh
    (it raised there before the packed step was ported to it): the ranks'
    ``Trainer`` steps agree with each other and with the one-rank packed
    step."""
    with pytest.raises(ValueError, match="space"):
        Trainer(_cfg({"data": 1, "space": 1}), "cpu",
                mesh=tmesh.Mesh(np.zeros((1, 2), int), {}, None))
    (l0, step0, s0), (l1, step1, s1) = (r["packed"]["trainer"]
                                        for r in readings["ranks"])
    assert step0 == step1 == 1 and l0 == l1
    for k in s0:
        assert torch.equal(s0[k], s1[k]), k
    want, _, ws = readings["ranks"][0]["packed"]["one_trainer"]
    assert abs(l0 - want) < PACKED_GATE["loss"] * abs(want)
    for k in ws:
        if "running" in k:
            assert (s0[k] - ws[k]).abs().max() <= PACKED_GATE["stats"], k


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
