"""ReLayNet's served int8 graph on the CUDA kernels K7 and K3.

Counterpart of the JAX package's ``inference/relaynet_psrp.py``. Its PSRP
layouts fill the TPU's lanes and are not part of the function; here every
activation is plain NHWC int8:

    stage   input -> output (512^2, f=64)          TPU kernel         here
    b0      image (Cin=1) -> 512^2, pool + idx     stem7_psrp         K7
    b1, b2  256^2, 128^2, pool + idx               conv7x3_psrp       K7
    b3      64^2 (bottleneck)                      conv7x3_psrp       K7
    b4..b6  cat [skip, unpool] at 128^2..512^2     conv7x3_psrp       K7
    head    1x1 conv + argmax -> (N, H, W) labels  head_argmax_psrp   K3

One forward launches K7 7 times and K3 once. The index pools are fused
into the producing conv (K7 writes the skip, the pooled tensor and the
window indices); each unpool is a plain torch op (the JAX package's is
XLA). A decoder's skip feeds K7 raw, its requant folded into the skip half
of the weights (``relaynet_int8.quantize_relaynet``).
"""

from __future__ import annotations

import torch

from ..ops.conv7x3_int8 import (
    _alpha32,
    conv7x3_int8,
    conv7x3_int8_reference,
    pack_conv7x3_weights,
)
from ..ops.head_argmax import (
    head_argmax,
    head_argmax_reference,
    pack_head_weights,
)
from ..ops.pooling import max_unpool
from ..utils.profiling import annotate
from .relaynet_int8 import NBLOCKS, quantize_relaynet


def attach_kernel_params(q: dict, device=None) -> dict:
    """int8 qparams -> serving qparams on ``device``: each block gains its
    kernel-ordered weights ``w_k``, its fused-epilogue ``scale`` and ``bias``
    (float32, ``(s_in*s_w)/s_out`` and ``b/s_out``) and its slope as a
    float32-valued Python float; the head gains ``w_k`` and ``scale =
    s_b6_out*s_w``, ``bias = b``."""
    s = {k: v.to(device) for k, v in q["_act_scales"].items()}
    out = {"_act_scales": s}
    for i in range(NBLOCKS):
        name = f"b{i}"
        lw = {k: v.to(device) for k, v in q[name].items()}
        lw["w_k"] = pack_conv7x3_weights(lw["w_q"])
        s_out = s[f"{name}_out"]
        lw["scale"] = (s[f"{name}_in"] * lw["s_w"] / s_out).contiguous()
        lw["bias"] = (lw["b"] / s_out).contiguous()
        lw["slope"] = _alpha32(lw["alpha"])
        out[name] = lw
    hw = {k: v.to(device) for k, v in q["head"].items()}
    hw["w_k"] = pack_head_weights(hw["w_q"])
    hw["scale"] = (s["b6_out"] * hw["s_w"]).contiguous()
    hw["bias"] = hw["b"].contiguous()
    out["head"] = hw
    return out


def quantize_relaynet_psrp(layers: dict, taps: dict, *, device=None) -> dict:
    """Serving qparams for ``relaynet_psrp_forward``: ``quantize_relaynet``
    (the same scales and folded skip requants) plus the kernel parameters."""
    return attach_kernel_params(quantize_relaynet(layers, taps), device)


def relaynet_psrp_forward(qparams: dict, x: torch.Tensor, num_classes: int,
                          *, reference: bool = False) -> torch.Tensor:
    """(N, H, W, 1) float NHWC -> (N, H, W) int8 labels; H and W must be
    divisible by 8 (three pools).

    ``reference=True`` runs the kernels' plain PyTorch versions instead, on
    any device: the check that the kernels compute the same graph. Serving
    never sets it. With tracing on (``utils/profiling``) the input's
    quantisation is the span ``serve.preprocess`` and each unpool
    ``serve.unpool``."""
    N, H, W, C = x.shape
    if C != 1 or H % 8 or W % 8:
        raise ValueError(
            f"relaynet_psrp_forward: expected (N, H, W, 1) with H, W "
            f"divisible by 8, got {tuple(x.shape)}"
        )
    if qparams["head"]["w_k"].shape[0] != num_classes:
        raise ValueError(
            f"qparams have {qparams['head']['w_k'].shape[0]} classes, not "
            f"{num_classes}"
        )
    k7, k3 = ((conv7x3_int8_reference, head_argmax_reference) if reference
              else (conv7x3_int8, head_argmax))
    s = qparams["_act_scales"]

    def conv(inputs, name, pool=False):
        lw = qparams[name]
        return k7(inputs, lw["w_k"], lw["scale"], lw["bias"], lw["slope"],
                  pool=pool)

    with annotate("serve.preprocess"):
        h = torch.round(x.float() / s["b0_in"]).clamp(-127, 127).to(
            torch.int8)
    skips, idxs = [], []
    for i in range(3):
        skip, h, idx = conv(h, f"b{i}", pool=True)
        skips.append(skip)
        idxs.append(idx)
    h = conv(h, "b3")
    for j, (skip, idx) in enumerate(zip(reversed(skips), reversed(idxs))):
        with annotate("serve.unpool"):
            up = max_unpool(h, idx)
        h = conv((skip, up), f"b{4 + j}")
    hw = qparams["head"]
    return k3(h, hw["w_k"], hw["scale"], hw["bias"])
