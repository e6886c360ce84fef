"""The row-packed int8 U-Net graph (``infer --quantize packed``) on the CUDA
kernels.

Counterpart of the JAX package's ``inference/packed.py``, the round-2
serving graph. Its row packing (rows of 4 folded into the TPU's lanes) is a
layout, not part of the function: here the activations stay NHWC int8, and
its TPU kernels map onto the port's:

    stage                        TPU kernel                  here
    stem (Cin=1)                 stem_conv3x3_int8_packed    K1 conv3x3_int8
    blk0_conv1 .. blk1_conv1,    conv3x3_int8_packed         K1 (pool=True
      blk7_*, blk8_*               (+ finish_pool_w)           where it pools)
    blk2 .. blk6 (deep)          conv3x3_int8 (XLA on CPU)   K1
    the two deep pools           XLA reshape-max             K11 pool2x2_int8
    ct0 .. ct3                   ct_dot (XLA)                K2 ct2x2_int8
    head + argmax                head_argmax_packed          K3 head_argmax

One forward launches K1 18 times, K11 twice, K2 4 times and K3 once
(``LAUNCHES_PER_FORWARD``). What sets this graph apart from the PSRP one
(``inference/psrp.py``) is its quantization, kept as the JAX package has it:
only the skip halves of blk7_conv0 and blk8_conv0 are pre-scaled by
s_skip/s_cat before the weights are quantized; the skips of blk5 and blk6
are requantized explicitly (``round(q * (s_skip/s_cat))``); and the
transposed convs take the scale ``(s_in/s_out) * s_w``, a different float
order from the PSRP graph's ``(s_in*s_w)/s_out``. f=32 only, as in JAX.
"""

from __future__ import annotations

import torch

from ..ops.conv_int8 import (
    conv3x3_int8,
    conv3x3_int8_reference,
    ct2x2_int8,
    ct2x2_int8_reference,
    pool2x2_int8,
    pool2x2_int8_reference,
)
from ..ops.head_argmax import head_argmax, head_argmax_reference
from .psrp import attach_kernel_params
from .quantized import _requant, quant_weights, quantize_unet

# the shallow 3x3 stages of the TPU's packed kernel, with their input
# channel splits ((up, skip) for the two cat stages)
PACKED_STAGES = {
    "blk0_conv1": (32,),
    "blk1_conv0": (32,),
    "blk1_conv1": (64,),
    "blk7_conv0": (64, 64),
    "blk7_conv1": (64,),
    "blk8_conv0": (32, 32),
    "blk8_conv1": (32,),
}
# cat convs whose skip requant is folded into the weights -> skip key
FOLDED_SKIPS = {"blk7_conv0": "blk2_conv0_in", "blk8_conv0": "blk1_conv0_in"}
LAUNCHES_PER_FORWARD = {"conv3x3_int8": 18, "pool2x2_int8": 2,
                        "ct2x2_int8": 4, "head_argmax": 1}


def attach_packed_params(q: dict, device=None) -> dict:
    """Raw packed qparams -> serving qparams on ``device``: as
    ``psrp.attach_kernel_params``, with each transposed conv's scale formed
    as ``(s_in/s_out) * s_w`` (JAX ``packed.ct_dot``)."""
    out = attach_kernel_params(q, device)
    s = out["_act_scales"]
    for k in range(4):
        lw = out[f"ct{k}"]
        lw["scale"] = ((s[f"ct{k}_in"] / s[f"blk{k + 5}_cat"])
                       * lw["s_w"]).contiguous()
    return out


def quantize_unet_packed(layers: dict, taps: dict, init_features: int = 32,
                         *, device=None) -> dict:
    """Serving qparams for ``unet_packed_forward`` (f=32 only, as in JAX).

    ``quantize_unet``, with the weights of the packed stages quantized anew
    and the skip halves of blk7_conv0 and blk8_conv0 pre-scaled by
    s_skip/s_cat first (the same rounding as ``quant_weights``)."""
    f = layers["blk0_conv0"]["w"].shape[0]
    if init_features != 32 or f != 32:
        raise ValueError(
            f"the packed graph supports init_features=32 only (as the JAX "
            f"package's packing table), got init_features={init_features}, "
            f"layers of width {f}"
        )
    q = quantize_unet(layers, taps)
    s = q["_act_scales"]
    for name, cins in PACKED_STAGES.items():
        w = layers[name]["w"].clone()
        if name in FOLDED_SKIPS:
            w[:, cins[0]:] *= s[FOLDED_SKIPS[name]] / s[f"{name[:4]}_cat"]
        q[name]["w_q"], q[name]["s_w"] = quant_weights(w, name)
    return attach_packed_params(q, device)


def unet_packed_forward(qparams: dict, x: torch.Tensor, num_classes: int, *,
                        reference: bool = False) -> torch.Tensor:
    """(N, H, W, 1) float NHWC -> (N, H, W) int8 labels; H and W must be
    divisible by 16. ``reference=True`` runs the kernels' plain versions."""
    N, H, W, C = x.shape
    if C != 1 or H % 16 or W % 16:
        raise ValueError(
            f"unet_packed_forward: expected (N, H, W, 1) with H, W divisible "
            f"by 16, got {tuple(x.shape)}"
        )
    if qparams["blk0_conv0"]["w_q"].shape[0] != 32:
        raise ValueError("the packed graph supports init_features=32 only")
    if qparams["head"]["w_k"].shape[0] != num_classes:
        raise ValueError(
            f"qparams have {qparams['head']['w_k'].shape[0]} classes, not "
            f"{num_classes}"
        )
    s = qparams["_act_scales"]
    k1, k11, k2, k3 = (
        (conv3x3_int8_reference, pool2x2_int8_reference,
         ct2x2_int8_reference, head_argmax_reference) if reference
        else (conv3x3_int8, pool2x2_int8, ct2x2_int8, head_argmax))

    def conv(inputs, name, pool=False):
        lw = qparams[name]
        if not isinstance(inputs, tuple):
            inputs = (inputs,)
        return k1(inputs, lw["w_k"], lw["scale"], lw["bias"], relu=True,
                  pool=pool)

    def up(h, k):
        lw = qparams[f"ct{k}"]
        return k2(h, lw["w_k"], lw["scale"], lw["bias"])

    # the stem input is quantized by a division by the 0-d scale tensor
    h = torch.round(x.float() / s["blk0_conv0_in"]).clamp(-127, 127).to(
        torch.int8)
    h = conv(h, "blk0_conv0")
    enc0, h = conv(h, "blk0_conv1", pool=True)
    h = conv(h, "blk1_conv0")
    enc1, h = conv(h, "blk1_conv1", pool=True)
    deep = []
    for i in (2, 3):
        h = conv(conv(h, f"blk{i}_conv0"), f"blk{i}_conv1")
        deep.append((h, s[f"blk{i + 1}_conv0_in"]))
        h = k11(h)
    h = conv(conv(h, "blk4_conv0"), "blk4_conv1")
    for k, blk in ((0, 5), (1, 6)):
        sk, sk_s = deep[1 - k]
        sk = _requant(sk, sk_s, s[f"blk{blk}_cat"])
        h = conv((up(h, k), sk), f"blk{blk}_conv0")
        h = conv(h, f"blk{blk}_conv1")
    h = conv((up(h, 2), enc1), "blk7_conv0")
    h = conv(h, "blk7_conv1")
    h = conv((up(h, 3), enc0), "blk8_conv0")
    h = conv(h, "blk8_conv1")
    lw = qparams["head"]
    return k3(h, lw["w_k"], lw["scale"], lw["bias"])
