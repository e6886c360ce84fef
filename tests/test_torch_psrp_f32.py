"""The port's served int8 graph (f=32, 64x64, 10 classes) against the JAX
package's PSRP graph on the CPU.

Given JAX's own qparams, the labels agree to >= 0.999: the only gap is that
the JAX CPU graph runs its deep stages through the eager ``_qconv``
(requant rounded twice, ``(acc*s_in*s_w + b)/s_out``) where the port, like
the JAX TPU graph, fuses ``(s_in*s_w)/s_out`` into one FMA epilogue. With
its own fold and calibration the port meets the JAX graph's contract
(tests/test_psrp_forward.py): > 0.995 vs the all-int8 graph, > 0.95 vs
float.
"""

import pytest
import torch

from test_torch_common import (
    agreement,
    port_psrp_labels_full_pipeline,
    port_psrp_labels_given_jax_qparams,
    psrp_reference_case,
)


@pytest.fixture(scope="module")
def case():
    return psrp_reference_case(32)


def test_unet_psrp_forward_given_jax_qparams(case):
    lab = port_psrp_labels_given_jax_qparams(case)
    assert lab.dtype == torch.int8 and lab.shape == (2, 64, 64)
    assert agreement(lab, case["psrp"]) >= 0.999


def test_unet_psrp_forward_full_pipeline(case):
    lab = port_psrp_labels_full_pipeline(case)
    assert agreement(lab, case["int8"]) > 0.995
    assert agreement(lab, case["float"]) > 0.95
