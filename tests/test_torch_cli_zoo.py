"""The port's CLI around checkpoints and the zoo, on the CPU:
``--checkpoint`` reads the file that ``train --checkpoint-dir`` writes, a
``save_model`` file and a bare state dict (anything else raises, naming its
keys); ``smoke`` reports a failing model and goes on, and raises under
``--strict``, as the JAX CLI's; ``smoke`` runs MGU-Net, ISLAM, LightReSeg,
MSNet, M2SNet, BioNet, WAT-Net, Masood and RetiFluidNet at the JAX CLI's
sizes with the JAX models' parameter counts; ``train`` and ``infer``
refuse BioNet (the others run through ``Trainer`` in
tests/test_torch_cli_zoo_train.py).
"""

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli

NC = 5


def _port(argv):
    return cli.main([argv[0], *argv[1:], "--device", "cpu"])


def test_eval_reads_the_checkpoint_train_wrote(tmp_path):
    """``train --checkpoint-dir d`` writes ``d/ckpt_0.pt`` (the manager's
    train state and metrics); ``eval --checkpoint`` on it builds the
    trained weights and scores them: the same confusion as from a
    ``save_model`` file and from a bare model state dict of the same state.
    A file of another shape raises, naming its keys."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.checkpoint import (
        load_model,
        save_model,
    )

    d = tmp_path / "ckpt"
    width = ["--model-kwargs", '{"init_features": 4}']
    state = _port(["train", "--image-size", "32", "--epochs", "1",
                   "--batch-size", "2", "--num-train", "4", "--num-val",
                   "2", "--num-classes", str(NC), "--dtype", "float32",
                   "--checkpoint-dir", str(d), *width])
    assert sorted(p.name for p in d.iterdir()) == ["ckpt_0.pt"]
    save_model(str(tmp_path / "whole.pt"), state)
    torch.save(state.model.state_dict(), tmp_path / "bare.pt")
    evals = ["eval", "--image-size", "32", "--num-val", "2", "--num-classes",
             str(NC), "--batch-size", "2", "--dtype", "float32", *width]
    files = (d / "ckpt_0.pt", tmp_path / "whole.pt", tmp_path / "bare.pt")
    for f in files:
        trainer, _ = cli.build_eval_trainer(cli.parser().parse_args(
            [*evals, "--device", "cpu", "--checkpoint", str(f)]))
        for k, v in state.model.state_dict().items():
            assert torch.equal(trainer.model.state_dict()[k], v), (f, k)
    got = [_port([*evals, "--checkpoint", str(f)])["confusion"]
           for f in files]
    assert all(np.array_equal(g, got[0]) for g in got)
    # load_model restores the whole state
    twin = cli.build_training(cli.parser().parse_args([
        "train", "--device", "cpu", "--image-size", "32",
        "--num-classes", str(NC), *width]))[0].init_state()
    load_model(str(tmp_path / "whole.pt"), twin)
    assert twin.step == state.step
    for k, v in state.model.state_dict().items():
        assert torch.equal(twin.model.state_dict()[k], v), k
    torch.save({"weights": {"a": 1}, "epoch": 3}, tmp_path / "other.pt")
    with pytest.raises(ValueError, match=r"\['epoch', 'weights'\]"):
        _port([*evals, "--checkpoint", str(tmp_path / "other.pt")])


def test_smoke_reports_a_failing_model_and_goes_on(monkeypatch, capsys):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import (
        registry,
    )

    def broken(**kw):
        raise RuntimeError("planted")

    monkeypatch.setitem(registry._MODELS, "unet", broken)
    argv = ["smoke", "--model", "unet", "--device", "cpu"]
    assert cli.main(argv) is None
    assert capsys.readouterr().out.split() == ["unet", "FAIL:",
                                               "RuntimeError:", "planted"]
    with pytest.raises(RuntimeError, match="planted"):
        cli.main([*argv, "--strict"])


@pytest.mark.parametrize("name,size", [("mgunet", 160), ("mgunet_2", 160),
                                       ("islam", 64), ("lightreseg", 64)])
def test_smoke_new_models_at_the_jax_sizes(name, size, capsys):
    """``smoke`` runs MGU-Net at 160x160 (the JAX CLI's size for it) and
    the others at 64x64, with the JAX model's parameter count
    (``jax.eval_shape`` of the JAX CLI's init)."""
    import jax
    import jax.numpy as jnp

    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    cli.main(["smoke", "--model", name, "--num-classes", "4", "--device",
              "cpu", "--strict"])
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith(name) and " ok " in line
    assert f"(1, 4, {size}, {size})" in line
    shapes = jax.eval_shape(jax_get_model(name, num_classes=4).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 1)))
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert f"params={n:>12,}" in line


# the six names of the last slice: the output's shape at 64x64, 4 classes
ZOO3_SMOKE = {"msnet": "(1, 4, 64, 64)", "m2snet": "(1, 4, 64, 64)",
              "bionet": "((1, 4, 64, 64), (1, 2, 64, 64), (1, 1))",
              "watnet": "(1, 4, 64, 64)", "masood": "(1, 4, 64, 64)",
              "retifluidnet": "(1, 60, 64, 64)"}


@pytest.mark.parametrize("name", list(ZOO3_SMOKE))
def test_smoke_zoo3_at_the_jax_sizes(name, capsys):
    """``smoke`` runs MSNet, M2SNet, BioNet, WAT-Net, Masood and
    RetiFluidNet at 64x64 (the JAX CLI's size) with the JAX model's
    parameter count; BioNet prints its three outputs' shapes,
    RetiFluidNet its 40 + 5 * 4 channels."""
    import jax
    import jax.numpy as jnp

    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    cli.main(["smoke", "--model", name, "--num-classes", "4", "--device",
              "cpu", "--strict"])
    (line,) = capsys.readouterr().out.splitlines()
    assert line.startswith(name) and " ok " in line
    assert f"out={ZOO3_SMOKE[name]}" in line
    shapes = jax.eval_shape(jax_get_model(name, num_classes=4).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    n = sum(int(np.prod(t.shape)) for t in jax.tree.leaves(shapes["params"]))
    assert f"params={n:>12,}" in line


def test_bionet_train_and_infer_refused():
    """BioNet's forward is three tensors and neither package trains it:
    ``train`` raises naming them, ``infer`` and ``eval`` exit."""
    common = ["--model", "bionet", "--image-size", "32", "--batch-size",
              "2", "--num-classes", "4"]
    with pytest.raises(ValueError, match=r"\(seg_pred, gms_out, bio_out\)"):
        _port(["train", *common, "--epochs", "1", "--num-train", "2"])
    for cmd in ("infer", "eval"):
        with pytest.raises(SystemExit, match="one tensor of logits"):
            _port([cmd, *common])
