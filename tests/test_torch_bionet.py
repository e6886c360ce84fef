"""The port's ResNet backbones and BioNet (``models/resnet.py``,
``models/bionet.py``) against the JAX package's on the same numpy-seeded
inputs and weights, carried by ``utils/convert.layer_map``: ResNet-18
with ``capture_stages`` and a bottleneck ResNet, and BioNet's three
outputs at 64x64, batch 2, in eval and train mode at 1e-4 scale-relative
with the running statistics after the train call; a stride-2
``BasicBlock``'s train-mode gradient against ``jax.grad``; the parameter tree at the default width."""

import functools

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu.models import (
    bionet as jbionet,
    resnet as jresnet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models import (
    bionet,
    resnet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
    get_model,
)
from test_torch_common import (
    check_zoo_forward,
    check_zoo_gradient,
    default_tree_matches,
    jax_eval_train,
    jax_variables,
    normal_images,
)

NC, TOL, HW = 3, 1e-4, 64
# (label, JAX kwargs): ResNet-18 returning [stem, layer1..4], and a
# bottleneck ResNet of one block a stage (x4 expansion, downsample on
# every first block)
RESNETS = {"resnet18-stages": {"capture_stages": True},
           "bottleneck": {"stage_sizes": (1, 1, 1, 1),
                          "block": "bottleneck"}}


@functools.lru_cache(maxsize=None)
def _jax_resnet(label):
    jm = jresnet.ResNetFeatures(**RESNETS[label])
    x = normal_images(2, 2, HW)
    v = jax_variables(jm, x)
    return (x, v) + tuple(jax_eval_train(jm, x, v))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("label", list(RESNETS))
def test_resnet_features(label, train):
    x, v, want_eval, want_train, stats = _jax_resnet(label)
    want = want_train if train else want_eval
    tm = resnet.ResNetFeatures(1, generator=torch.Generator(),
                               **RESNETS[label])
    got = check_zoo_forward(tm, v, x, tuple(want) if isinstance(
        want, list) else want, stats, train, TOL)
    if label == "resnet18-stages":
        assert [tuple(t.shape[-3:]) for t in got] == [
            (64, 32, 32), (64, 16, 16), (128, 8, 8), (256, 4, 4),
            (512, 2, 2)]


@functools.lru_cache(maxsize=None)
def _jax_bionet():
    """(input, variables, eval outputs, train outputs, batch_stats)."""
    jm = jbionet.BioNet(num_classes=NC)
    x = normal_images(1, 2, HW)
    v = jax_variables(jm, x)
    return (x, v) + tuple(jax_eval_train(jm, x, v))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_bionet_forward(train):
    """``(seg_pred, gms_out, bio_out)``, each at 1e-4."""
    x, v, want_eval, want_train, stats = _jax_bionet()
    tm = bionet.BioNet(1, NC, generator=torch.Generator())
    got = check_zoo_forward(tm, v, x, want_train if train else want_eval,
                            stats, train, TOL)
    assert [tuple(t.shape) for t in got] == [(2, NC, HW, HW),
                                             (2, 2, HW, HW), (2, 1)]


def test_basic_block_gradient():
    """The family's gradient: a stride-2 ``BasicBlock`` with its 1x1
    downsample (ResNet-18's first block of layer2-4) in train mode
    against ``jax.grad``. BioNet's own float32 gradient is no reference:
    a bias before a linear layer and a train-mode BatchNorm (the
    regulariser's 1x1 projection, the U-Nets' transposed convs) has a
    gradient that is zero but for the borders' padding, and the JAX twin's
    reads 2e-3 to 3e-3 of its size from the port's there."""
    jm = jresnet.BasicBlock(64, 2, True)
    x = np.maximum(normal_images(6, 2, 16).repeat(32, axis=-1)
                   * np.random.default_rng(7).uniform(-1, 1, 32), 0).astype(
        np.float32)
    v = jax_variables(jm, x)
    cot = np.random.default_rng(8).standard_normal((2, 8, 8, 64)).astype(
        np.float32)
    *_, grads = jax_eval_train(jm, x, v, cot)
    tm = resnet.BasicBlock(32, 64, 2, True, generator=torch.Generator())
    check_zoo_gradient(tm, v, x, cot, grads, TOL)


def test_default_width_parameters():
    from retinal_oct_image_segmentation_via_deep_learning_tpu.registry import (
        get_model as jax_get_model,
    )

    default_tree_matches(jax_get_model("bionet"),
                         get_model("bionet", in_channels=1), HW)
