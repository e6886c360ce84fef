"""The port's CLI trains the zoo, on the CPU: ``train`` runs MGU-Net (both
variants), ISLAM, LightReSeg, MSNet, M2SNet, WAT-Net, Masood and
RetiFluidNet through ``Trainer`` and ``infer`` writes their masks (split
from tests/test_torch_cli_zoo.py, so that no one file carries the zoo's
CLI under ``--dist loadfile``).
"""

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli


def _port(argv):
    return cli.main([argv[0], *argv[1:], "--device", "cpu"])


@pytest.mark.parametrize("name,size,kwargs", [
    ("mgunet", 160, '{"feature_scale": 16}'),
    ("mgunet_2", 64, '{"feature_scale": 16}'),
    ("islam", 32, "{}"),
    ("lightreseg", 32, "{}"),
    ("msnet", 32, "{}"),
    ("m2snet", 32, "{}"),
    ("watnet", 32, "{}"),
    ("masood", 32, "{}"),
    ("retifluidnet", 64, '{"base_channels": 8}'),
])
def test_train_then_infer_new_models(name, size, kwargs, tmp_path):
    """``train`` runs each new model through ``Trainer`` (one epoch of two
    steps, finite losses, its BatchNorms' running statistics moved) and
    ``infer`` writes its masks (the checkpoint round trip is
    ``test_eval_reads_the_checkpoint_train_wrote``'s)."""
    common = ["--model", name, "--image-size", str(size), "--batch-size",
              "2", "--num-classes", "4", "--dtype", "float32",
              "--model-kwargs", kwargs]
    log = tmp_path / "log.jsonl"
    state = _port(["train", *common, "--epochs", "1", "--num-train", "4",
                   "--num-val", "2", "--log-file", str(log)])
    assert state.step == 2
    rec = log.read_text().splitlines()
    assert len(rec) == 1
    assert np.isfinite(float(rec[0].split('"train_loss": ')[1].split(",")[0]))
    stats = [m.running_var for m in state.model.modules()
             if isinstance(m, torch.nn.BatchNorm2d)]
    assert stats and all(not torch.all(v == 1) for v in stats)
    masks = _port(["infer", *common, "--out-dir", str(tmp_path / "o")])
    assert tuple(masks.shape) == (2, size, size)
    assert np.load(tmp_path / "o" / "masks.npy").shape == (2, size, size)
