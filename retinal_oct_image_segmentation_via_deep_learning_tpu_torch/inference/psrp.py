"""The served int8 U-Net graph on the three CUDA kernels.

Counterpart of the JAX package's ``inference/psrp.py`` (its phase-split
row-packed graph). The PSRP layouts there fill the TPU's lanes and are not
part of the function; here every activation is plain NHWC int8 and the
seven TPU kernels of that graph map onto three:

    stage                        TPU kernel            here
    stem (blk0_conv0, Cin=1)     stem_psrp             K1 conv3x3_int8
    blk0_conv1 .. blk1_conv1,    conv3x3_psrp          K1 (pool=True for
      blk7_*, blk8_*                                     the pooled stages)
    blk2 .. blk6 (deep)          conv3x3_int8          K1 (the two deep
                                                         pools fused too)
    ct0, ct1                     ct2x2_int8            K2 ct2x2_int8
    ct2                          ct_up_psrp            K2
    ct3                          ct_psrp               K2
    head + argmax                head_argmax_psrp      K3 head_argmax

One forward launches K1 18 times, K2 4 times and K3 once. With the fused
stem (``stem_fuse``, the JAX switch ``OCTSEG_PSRP_STEM_FUSE``) K10
``stem_conv_int8`` takes the place of K1's stem and blk0_conv1 calls
(TPU: ``stem_conv_psrp``): K10 once, K1 16 times. Skip concats are
folded into the consuming conv (K1 reads both inputs), and each skip's
requant (s_skip -> s_cat) is folded into the skip half of that conv's
weights before quantization, as the JAX graph does.
"""

from __future__ import annotations

import os

import torch

from ..ops.conv_int8 import (
    conv3x3_int8,
    conv3x3_int8_reference,
    ct2x2_int8,
    ct2x2_int8_reference,
    pack_conv3x3_weights,
    pack_ct2x2_weights,
)
from ..ops.head_argmax import (
    head_argmax,
    head_argmax_reference,
    pack_head_weights,
)
from ..ops.stem_conv_int8 import stem_conv_int8, stem_conv_int8_reference
from .quantized import quant_weights, quantize_unet

# cat conv -> activation key of its skip input (the skip's stored scale)
SKIP_KEYS = {
    "blk5_conv0": "blk4_conv0_in",
    "blk6_conv0": "blk3_conv0_in",
    "blk7_conv0": "blk2_conv0_in",
    "blk8_conv0": "blk1_conv0_in",
}


def _conv_keys(i: int, j: int) -> tuple[str, str]:
    """(input, output) activation keys of blk{i}_conv{j}."""
    if j == 0:
        return (f"blk{i}_cat" if i >= 5 else f"blk{i}_conv0_in",
                f"blk{i}_conv1_in")
    out = {4: "ct0_in", 5: "ct1_in", 6: "ct2_in", 7: "ct3_in",
           8: "head_in"}.get(i, f"blk{i + 1}_conv0_in")
    return f"blk{i}_conv1_in", out


def attach_kernel_params(q: dict, device=None) -> dict:
    """int8 qparams -> serving qparams on ``device``: each layer gains its
    kernel-ordered weights ``w_k`` and its fused-epilogue ``scale`` and
    ``bias`` (float32, computed as ``(s_in*s_w)/s_out`` and ``b/s_out``)."""
    s = {k: v.to(device) for k, v in q["_act_scales"].items()}
    out = {"_act_scales": s}
    for name, lw in q.items():
        if name == "_act_scales":
            continue
        lw = {k: v.to(device) for k, v in lw.items()}
        if name == "head":
            lw["w_k"] = pack_head_weights(lw["w_q"])
            lw["scale"] = (s["head_in"] * lw["s_w"]).contiguous()
            lw["bias"] = lw["b"].contiguous()
        else:
            if name.startswith("ct"):
                k = int(name[2:])
                in_key, out_key = f"ct{k}_in", f"blk{k + 5}_cat"
                lw["w_k"] = pack_ct2x2_weights(lw["w_q"])
            else:
                in_key, out_key = _conv_keys(int(name[3]), int(name[-1]))
                lw["w_k"] = pack_conv3x3_weights(lw["w_q"])
            lw["scale"] = (s[in_key] * lw["s_w"] / s[out_key]).contiguous()
            lw["bias"] = (lw["b"] / s[out_key]).contiguous()
        out[name] = lw
    return out


def quantize_unet_psrp(layers: dict, taps: dict, init_features: int = 32,
                       deep_int4=False, *, device=None) -> dict:
    """Serving qparams for ``unet_psrp_forward`` (int8 mode).

    As ``quantize_unet``, except that each cat conv's skip-half weights are
    pre-scaled by s_skip/s_cat before quantization, so the skip feeds the
    kernel raw. Any ``init_features`` works (there is no stage table)."""
    if deep_int4:
        raise NotImplementedError(
            "the w4a4 mode is not ported yet; see ROADMAP.md, Queue A"
        )
    f = layers["blk0_conv0"]["w"].shape[0]
    if f != init_features:
        raise ValueError(f"layers have init_features={f}, not {init_features}")
    q = quantize_unet(layers, taps)
    s = q["_act_scales"]
    for name, skip_key in SKIP_KEYS.items():
        blk = name[:4]
        w = layers[name]["w"].clone()
        w[:, w.shape[1] // 2:] *= s[skip_key] / s[f"{blk}_cat"]
        q[name]["w_q"], q[name]["s_w"] = quant_weights(w, name)
    return attach_kernel_params(q, device)


def stem_fuse_default() -> bool:
    """The JAX package's switch: any non-empty ``OCTSEG_PSRP_STEM_FUSE``
    turns the fused stem on."""
    return bool(os.environ.get("OCTSEG_PSRP_STEM_FUSE"))


def unet_psrp_forward(qparams: dict, x: torch.Tensor, num_classes: int, *,
                      reference: bool = False,
                      stem_fuse: bool | None = None) -> torch.Tensor:
    """(N, H, W, 1) float NHWC -> (N, H, W) int8 labels; H and W must be
    divisible by 16.

    ``reference=True`` runs the kernels' plain PyTorch versions instead, on
    any device: the check that the kernels compute the same graph. Serving
    never sets it. ``stem_fuse`` (default: ``stem_fuse_default()``) runs
    the stem, blk0_conv1 and its pool in one K10 launch; the labels are the
    same bit for bit."""
    N, H, W, C = x.shape
    if C != 1 or H % 16 or W % 16:
        raise ValueError(
            f"unet_psrp_forward: expected (N, H, W, 1) with H, W divisible "
            f"by 16, got {tuple(x.shape)}"
        )
    if qparams["head"]["w_k"].shape[0] != num_classes:
        raise ValueError(
            f"qparams have {qparams['head']['w_k'].shape[0]} classes, not "
            f"{num_classes}"
        )
    if stem_fuse is None:
        stem_fuse = stem_fuse_default()
    s = qparams["_act_scales"]
    k1, k2, k3 = ((conv3x3_int8_reference, ct2x2_int8_reference,
                   head_argmax_reference) if reference
                  else (conv3x3_int8, ct2x2_int8, head_argmax))

    def conv(inputs, name, pool=False):
        lw = qparams[name]
        if not isinstance(inputs, tuple):
            inputs = (inputs,)
        return k1(inputs, lw["w_k"], lw["scale"], lw["bias"], relu=True,
                  pool=pool)

    h = torch.round(x.float() / s["blk0_conv0_in"]).clamp(-127, 127).to(
        torch.int8
    )
    skips = []
    if stem_fuse:
        k10 = stem_conv_int8_reference if reference else stem_conv_int8
        l0, l1 = qparams["blk0_conv0"], qparams["blk0_conv1"]
        skip, h = k10(h, l0["w_k"], l0["scale"], l0["bias"], l1["w_k"],
                      l1["scale"], l1["bias"])
        skips.append(skip)
    for i in range(len(skips), 4):
        h = conv(h, f"blk{i}_conv0")
        skip, h = conv(h, f"blk{i}_conv1", pool=True)
        skips.append(skip)
    h = conv(conv(h, "blk4_conv0"), "blk4_conv1")
    for ct, (blk, skip) in enumerate(zip((5, 6, 7, 8), reversed(skips))):
        lw = qparams[f"ct{ct}"]
        up = k2(h, lw["w_k"], lw["scale"], lw["bias"])
        h = conv((up, skip), f"blk{blk}_conv0")
        h = conv(h, f"blk{blk}_conv1")
    lw = qparams["head"]
    return k3(h, lw["w_k"], lw["scale"], lw["bias"])
