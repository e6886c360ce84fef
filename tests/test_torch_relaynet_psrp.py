"""ReLayNet's served int8 graph (``inference/relaynet_psrp.py``, the plain
versions of K7 and K3 on the CPU) against the JAX package (64x64, f=8, 4
classes):

* given JAX's qparams, 100% of the labels of JAX ``relaynet_psrp_forward``
  (Pallas in interpret mode): the kernels' plain versions are bit-exact to
  the Pallas kernels, and the epilogue constants are computed alike;
* with its own fold, calibration and quantization, agreement 1.0 with the
  port's all-int8 oracle: the JAX graph's own contract
  (tests/test_psrp7_kernels.py), on the same initialised weights;
* ``cli.build_relaynet_psrp_forward`` (what ``cli serve --model relaynet``
  serves) runs on the CPU and equals the graph on z-scored input.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    relaynet_int8 as jr,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    relaynet_psrp as jpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    relaynet_int8 as tr,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    relaynet_psrp as tpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.relaynet import (
    ReLayNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
    preprocess,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    relaynet_qparams_from_jax,
    relaynet_state_dict_from_jax,
)
from test_torch_common import agreement, jax_relaynet, normal_images

F, NC, HW = 8, 4, 64


def test_relaynet_psrp_forward_given_jax_qparams():
    _, v = jax_relaynet(F, NC, HW)
    layers = jr.fold_relaynet_bn(v)
    q = jpsrp.quantize_relaynet_psrp(
        layers, jr.calibrate_relaynet(layers, [normal_images(0, 2, HW)]))
    x = normal_images(1, 2, HW)
    want = np.asarray(jpsrp.relaynet_psrp_forward(q, jnp.asarray(x),
                                                  num_classes=NC))
    qp = tpsrp.attach_kernel_params(relaynet_qparams_from_jax(q))
    got = tpsrp.relaynet_psrp_forward(qp, torch.from_numpy(x), NC)
    assert got.dtype == torch.int8 and got.shape == (2, HW, HW)
    assert agreement(got, want) == 1.0
    assert len(np.unique(want)) > 1


def test_relaynet_psrp_forward_own_pipeline_matches_oracle():
    _, v = jax_relaynet(F, NC, HW, randomize=False)
    model = ReLayNet(1, NC, F)
    model.load_state_dict(relaynet_state_dict_from_jax(v))
    layers = tr.fold_relaynet_bn(model)
    taps = tr.calibrate_relaynet(layers, [normal_images(0, 2, HW)])
    x = torch.from_numpy(normal_images(1, 2, HW))
    lab = tpsrp.relaynet_psrp_forward(
        tpsrp.quantize_relaynet_psrp(layers, taps), x, NC)
    want = tr.relaynet_int8_forward(tr.quantize_relaynet(layers, taps),
                                    x).argmax(-1)
    assert agreement(lab, want) == 1.0
    with pytest.raises(ValueError, match="divisible by 8"):
        tpsrp.relaynet_psrp_forward(tpsrp.quantize_relaynet_psrp(
            layers, taps), torch.zeros(1, HW, HW + 4, 1), NC)


def test_build_relaynet_psrp_forward_on_cpu():
    model = cli.build_model("relaynet", num_classes=NC, init_features=F,
                            seed=0, device="cpu")
    assert model.encode1.conv.out_channels == F
    forward, calib = cli.build_relaynet_psrp_forward(model, image_size=HW,
                                                     device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (3, HW, HW, 1)).astype(np.float32))
    with torch.inference_mode():
        lab = forward(imgs)
        want = tpsrp.relaynet_psrp_forward(calib["qparams"],
                                           preprocess(imgs), NC)
    assert lab.shape == (3, HW, HW) and lab.dtype == torch.int8
    assert torch.equal(lab, want)
    # the default width is ReLayNet's 64
    assert cli.build_model("relaynet", num_classes=NC, device="cpu") \
        .encode1.conv.out_channels == 64
    # calibrated on z-scored normal images, not on zeros: no collapsed scale
    assert min(calib["taps"].values()) > 0.1
