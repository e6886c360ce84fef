"""The served int8 U-Net graph on the three CUDA kernels, and its w4a4 mode.

Counterpart of the JAX package's ``inference/psrp.py`` (its phase-split
row-packed graph). The PSRP layouts there fill the TPU's lanes and are not
part of the function; here every activation is plain NHWC int8 and the
seven TPU kernels of that graph map onto three:

    stage                        TPU kernel            here
    stem (blk0_conv0, Cin=1)     stem_psrp             K1 conv3x3_int8 (its
                                                         stem body)
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
(TPU: ``stem_conv_psrp``): K10 once, K1 16 times. With the fused head
(``head_fuse``, the JAX switch ``OCTSEG_PSRP_HEAD_FUSE``; TPU:
``conv3x3_psrp(head=...)``) blk8_conv1's K1 launch ends in the head and
argmax: K1 18 times, K3 never. Skip concats are folded into the consuming
conv (K1 reads both inputs), and each skip's requant (s_skip -> s_cat) is
folded into the skip half of that conv's weights before quantization, as
the JAX graph does.

The w4a4 mode (``quantize_unet_psrp(deep_int4=True | "w4" | "a4")``, as
JAX's) serves the deep region (blk2..blk6, ct0, ct1) and the mid-resolution
stages blk1_conv0, blk1_conv1 and blk7_conv1 with 4-bit weights (absmax/7)
and 4-bit activations, still stored in int8, on the same kernels and the
same launches:

* relu outputs consumed by a 4-bit conv (``ZP7_KEYS``) are stored as
  levels [0, 14] shifted by -7 ("zero point 7", scale s*127/14): the
  producer folds -7 into its bias and clips at +-7 without relu; the
  consumer adds ``7*scale*wsum4`` to its bias and pads its borders with
  -7, the stored zero;
* the ct0/ct1 outputs (``SYM7_KEYS``) are symmetric +-7 (scale s*127/7);
  their zero-point fold differs per tap, so K2 takes a per-column bias;
* blk0_conv1 and blk1_conv1 keep their unpooled skip at 8 bits and
  requantize only the pooled tensor to zero point 7, from the float32
  values before rounding (K1's split-scale pool).

The mode travels as keys, as in JAX: ``_deep_int4`` (w4a4), ``_deep_w4``
(4-bit weights only), ``_deep_a4`` (4-bit activations only) and
``_w8_<stage>`` (that stage's weights kept at 8 bits). Every layer's
epilogue (scale, bias, relu, clip, border values, pool rescale) is fixed
at quantize time by ``attach_kernel_params``.
"""

from __future__ import annotations

import os

import torch

from ..ops.conv_int8 import (
    conv3x3_int8,
    conv3x3_int8_reference,
    ct2x2_int8,
    ct2x2_int8_reference,
    pack_conv3x3_mma_weights,
    pack_conv3x3_weights,
    pack_ct2x2_weights,
    pack_stem_mma_weights,
)
from ..ops.head_argmax import (
    head_argmax,
    head_argmax_reference,
    pack_head_weights,
)
from ..ops.stem_conv_int8 import stem_conv_int8, stem_conv_int8_reference
from ..utils.profiling import annotate
from .quantized import quant_weights, quantize_unet

# cat conv -> activation key of its skip input (the skip's stored scale)
SKIP_KEYS = {
    "blk5_conv0": "blk4_conv0_in",
    "blk6_conv0": "blk3_conv0_in",
    "blk7_conv0": "blk2_conv0_in",
    "blk8_conv0": "blk1_conv0_in",
}
DEEP_STAGES = tuple(f"blk{i}_conv{j}" for i in (2, 3, 4, 5, 6) for j in (0, 1))
POOLED_STAGES = ("blk0_conv1", "blk1_conv1", "blk2_conv1", "blk3_conv1")

# The w4a4 mode's 4-bit activations (JAX ``inference/psrp.py``): relu
# outputs stored at zero point 7, and the symmetric ct0/ct1 outputs. The
# enc0/enc1 skips and ct2_in/ct3_in stay 8-bit.
ZP7_KEYS = frozenset(
    [f"blk{i}_conv{j}_in" for i in (1, 2, 3, 4) for j in (0, 1)]
    + ["ct0_in", "blk5_conv1_in", "ct1_in", "blk6_conv1_in",
       "blk7_conv1_in"]
)
SYM7_KEYS = frozenset(["blk5_cat", "blk6_cat"])
INT4_KEYS = ZP7_KEYS | SYM7_KEYS
# a 4-bit tensor's stored scale is its calibrated scale times these
ZP7_RATIO = 127.0 / 14.0
SYM7_RATIO = 127.0 / 7.0
# mid-resolution stages whose weights are 4-bit under the w4a4 mode
INT4_PSRP_STAGES = ("blk1_conv0", "blk1_conv1", "blk7_conv1")
DEEP_INT4_MODES = (False, True, "w4", "a4")


def _conv_keys(i: int, j: int) -> tuple[str, str]:
    """(input, output) activation keys of blk{i}_conv{j}."""
    if j == 0:
        return (f"blk{i}_cat" if i >= 5 else f"blk{i}_conv0_in",
                f"blk{i}_conv1_in")
    out = {4: "ct0_in", 5: "ct1_in", 6: "ct2_in", 7: "ct3_in",
           8: "head_in"}.get(i, f"blk{i + 1}_conv0_in")
    return f"blk{i}_conv1_in", out


def act4(q: dict) -> bool:
    """Whether qparams hold 4-bit activations (the w4a4 and a4 modes)."""
    return "_deep_int4" in q or "_deep_a4" in q


def _stored_scale(s: dict, key: str, a4: bool) -> torch.Tensor:
    """The scale a tensor is stored at: its calibrated scale, times the
    4-bit ratio under 4-bit activations (float32, as JAX's ``sdeep``)."""
    if a4 and key in ZP7_KEYS:
        return s[key] * torch.tensor(ZP7_RATIO, dtype=torch.float32)
    if a4 and key in SYM7_KEYS:
        return s[key] * torch.tensor(SYM7_RATIO, dtype=torch.float32)
    return s[key]


def _conv_epilogue(name: str, lw: dict, s: dict, a4: bool, n_in: int):
    """(scale, bias, K1 knobs) of conv ``name``, in the float32 operation
    order of JAX's ``pconv``/``dconv`` (``inference/psrp.py``)."""
    in_key, out_key = _conv_keys(int(name[3]), int(name[-1]))
    deep, pool = name in DEEP_STAGES, name in POOLED_STAGES
    # a pooled mid-resolution stage's unpooled output keeps the base scale
    s_out = s[out_key] if pool and not deep else _stored_scale(s, out_key, a4)
    scale = _stored_scale(s, in_key, a4) * lw["s_w"] / s_out
    bias = lw["b"] / s_out
    knobs = {"relu": True, "out_clip": 127.0, "pad_vals": None,
             "pool_rescale": None, "pool_shift": 0.0, "pool_clip": None}
    if a4:
        if deep or in_key in ZP7_KEYS:
            # zero-point-7 input: +7*sum(w) over its channels, and borders
            # padded with the stored zero (a cat conv's up half is sym7)
            bias = bias + 7.0 * scale * lw["wsum4"]
            knobs["pad_vals"] = (0, -7) if n_in == 2 else (-7,)
        if out_key in INT4_KEYS:
            if pool and not deep:
                # split scale: only the pooled tensor goes to zero point 7
                knobs.update(pool_rescale=1.0 / ZP7_RATIO, pool_shift=-7.0,
                             pool_clip=7.0)
            else:
                # zero-point-7 output: -7 in the bias, the clip does relu
                bias = bias - 7.0
                knobs.update(relu=False, out_clip=7.0)
    return scale, bias, knobs


def attach_kernel_params(q: dict, device=None) -> dict:
    """Raw qparams -> serving qparams on ``device``: each layer gains its
    kernel-ordered weights ``w_k`` (and ``w_m``, the order of K1's
    tensor-core bodies: ``pack_stem_mma_weights`` for the stem,
    ``pack_conv3x3_mma_weights`` for every 3x3 conv of more than 4 input
    channels), its fused-epilogue
    ``scale`` and ``bias`` (float32, ``(s_in*s_w)/s_out`` and ``b/s_out`` with the w4a4
    mode's folds) and, for K1 and K2, the rest of its epilogue
    (``knobs``: relu, clip, border values, pool rescale). Mode keys
    (``_deep_*``, ``_w8_*``) are kept."""
    s = {k: v.to(device) for k, v in q["_act_scales"].items()}
    a4 = act4(q)
    out = {"_act_scales": s}
    for name, lw in q.items():
        if name.startswith("_"):
            if name != "_act_scales":
                out[name] = lw
            continue
        lw = {k: v.to(device) for k, v in lw.items()}
        if name == "head":
            lw["w_k"] = pack_head_weights(lw["w_q"])
            lw["scale"] = (s["head_in"] * lw["s_w"]).contiguous()
            lw["bias"] = lw["b"].contiguous()
        elif name.startswith("ct"):
            k = int(name[2:])
            in_key, out_key = f"ct{k}_in", f"blk{k + 5}_cat"
            lw["w_k"] = pack_ct2x2_weights(lw["w_q"])
            s_out = _stored_scale(s, out_key, a4)
            scale = _stored_scale(s, in_key, a4) * lw["s_w"] / s_out
            bias = lw["b"] / s_out
            lw["knobs"] = {"out_clip": 127.0}
            if a4 and k < 2:
                # each output pixel is one tap of one zero-point-7 input
                # pixel: the fold is per (dy, dx, co), K2's column order
                bias = (bias + 7.0 * scale * lw["wsum4"]).reshape(-1)
                lw["knobs"] = {"out_clip": 7.0}
            lw["scale"], lw["bias"] = scale.contiguous(), bias.contiguous()
        else:
            lw["w_k"] = pack_conv3x3_weights(lw["w_q"])
            # the orders of K1's tensor-core bodies
            if name == "blk0_conv0":
                lw["w_m"] = pack_stem_mma_weights(lw["w_q"])
            elif lw["w_q"].shape[1] > 4:
                lw["w_m"] = pack_conv3x3_mma_weights(lw["w_q"])
            n_in = 2 if name in SKIP_KEYS else 1
            scale, bias, lw["knobs"] = _conv_epilogue(name, lw, s, a4, n_in)
            lw["scale"], lw["bias"] = scale.contiguous(), bias.contiguous()
        out[name] = lw
    return out


def _wsum4(w_q: torch.Tensor, name: str) -> torch.Tensor:
    """float32 sums of the final int8 weights over the zero-point-7 input
    channels: per output channel for a conv (a deep cat conv's skip half
    only), per (dy, dx, co) for ct0/ct1 (JAX's layout)."""
    w = w_q.to(torch.int64)
    if name.startswith("ct"):
        return w.sum(0).permute(1, 2, 0).float()
    if name in ("blk5_conv0", "blk6_conv0"):
        w = w[:, w.shape[1] // 2:]
    return w.sum((1, 2, 3)).float()


def quantize_unet_psrp(layers: dict, taps: dict, init_features: int = 32,
                       deep_int4=False, int4_w8_stages=(), *,
                       device=None) -> dict:
    """Serving qparams for ``unet_psrp_forward``.

    As ``quantize_unet``, except that each cat conv's skip-half weights are
    pre-scaled by s_skip/s_cat before quantization, so the skip feeds the
    kernel raw. Any ``init_features`` works (there is no stage table).

    ``deep_int4`` (JAX's): ``True`` the w4a4 mode; ``"w4"`` 4-bit weights
    only, ``"a4"`` 4-bit activations only (accuracy attribution).
    ``int4_w8_stages``: stages (conv names, "ct0", "ct1") whose weights stay
    8-bit under it. The weights, scales and ``wsum4`` are JAX's bit for bit.
    """
    if deep_int4 not in DEEP_INT4_MODES:
        raise ValueError(f"deep_int4 {deep_int4!r}: one of {DEEP_INT4_MODES}")
    f = layers["blk0_conv0"]["w"].shape[0]
    if f != init_features:
        raise ValueError(f"layers have init_features={f}, not {init_features}")
    w4, a4 = deep_int4 in (True, "w4"), deep_int4 in (True, "a4")
    w8 = frozenset(int4_w8_stages) if deep_int4 else frozenset()
    q = quantize_unet(layers, taps)
    if deep_int4:
        q["_deep_int4" if deep_int4 is True else f"_deep_{deep_int4}"] = True
        for name in w8:
            q[f"_w8_{name}"] = True
    s = q["_act_scales"]
    int4_w = set(DEEP_STAGES + ("ct0", "ct1") + INT4_PSRP_STAGES) - w8
    for name in layers:
        lim = 7 if w4 and name in int4_w else 127
        w = layers[name]["w"]
        if name in SKIP_KEYS:
            # the deep skips are stored at zero point 7 under 4-bit
            # activations; the enc0/enc1 skips keep the base scale
            deep = a4 and name in DEEP_STAGES
            w = w.clone()
            w[:, w.shape[1] // 2:] *= (
                _stored_scale(s, SKIP_KEYS[name], deep)
                / _stored_scale(s, f"{name[:4]}_cat", deep))
        elif lim == 127:
            continue  # quantize_unet's weights
        q[name]["w_q"], q[name]["s_w"] = quant_weights(w, name, lim)
    if a4:
        for name in DEEP_STAGES + INT4_PSRP_STAGES + ("ct0", "ct1"):
            q[name]["wsum4"] = _wsum4(q[name]["w_q"], name)
    return attach_kernel_params(q, device)


def stem_fuse_default() -> bool:
    """The JAX package's switch: any non-empty ``OCTSEG_PSRP_STEM_FUSE``
    turns the fused stem on."""
    return bool(os.environ.get("OCTSEG_PSRP_STEM_FUSE"))


def head_fuse_default() -> bool:
    """The JAX package's switch: any non-empty ``OCTSEG_PSRP_HEAD_FUSE``
    turns the fused head on."""
    return bool(os.environ.get("OCTSEG_PSRP_HEAD_FUSE"))


def unet_psrp_forward(qparams: dict, x: torch.Tensor, num_classes: int, *,
                      reference: bool = False, stem_fuse: bool | None = None,
                      head_fuse: bool | None = None) -> torch.Tensor:
    """(N, H, W, 1) float NHWC -> (N, H, W) int8 labels; H and W must be
    divisible by 16.

    ``reference=True`` runs the kernels' plain PyTorch versions instead, on
    any device: the check that the kernels compute the same graph. Serving
    never sets it. ``stem_fuse`` (default: ``stem_fuse_default()``) runs
    the stem, blk0_conv1 and its pool in one K10 launch; ``head_fuse``
    (default: ``head_fuse_default()``, width <= 32) ends blk8_conv1's K1
    launch in the head and argmax. The labels are the same bit for bit.
    Under 4-bit activations the stem is never fused (K10 has no
    split-scale pool), as in JAX, and ``stem_fuse=True`` raises. With
    tracing on (``utils/profiling``) the input's quantisation is the span
    ``serve.preprocess``."""
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
    a4 = act4(qparams)
    if stem_fuse and a4:
        raise ValueError("stem_fuse: the fused stem has no split-scale pool, "
                         "so 4-bit activations take the two-kernel stem")
    if stem_fuse is None:
        stem_fuse = stem_fuse_default() and not a4
    if head_fuse is None:
        head_fuse = head_fuse_default()
    s = qparams["_act_scales"]
    k1, k2, k3 = ((conv3x3_int8_reference, ct2x2_int8_reference,
                   head_argmax_reference) if reference
                  else (conv3x3_int8, ct2x2_int8, head_argmax))

    def conv(inputs, name, head=None):
        lw = qparams[name]
        if not isinstance(inputs, tuple):
            inputs = (inputs,)
        return k1(inputs, lw["w_k"], lw["scale"], lw["bias"],
                  pool=name in POOLED_STAGES, head=head,
                  w_mma=lw.get("w_m"), **lw["knobs"])

    with annotate("serve.preprocess"):
        h = torch.round(x.float() / s["blk0_conv0_in"]).clamp(-127, 127).to(
            torch.int8
        )
    skips = []
    if stem_fuse:
        k10 = stem_conv_int8_reference if reference else stem_conv_int8
        l0, l1 = qparams["blk0_conv0"], qparams["blk0_conv1"]
        skip, h = k10(h, l0["w_k"], l0["scale"], l0["bias"], l1["w_k"],
                      l1["scale"], l1["bias"], (l0.get("w_m"), l1.get("w_m")))
        skips.append(skip)
    for i in range(len(skips), 4):
        h = conv(h, f"blk{i}_conv0")
        skip, h = conv(h, f"blk{i}_conv1")
        skips.append(skip)
    h = conv(conv(h, "blk4_conv0"), "blk4_conv1")
    for ct, (blk, skip) in enumerate(zip((5, 6, 7, 8), reversed(skips))):
        lw = qparams[f"ct{ct}"]
        up = k2(h, lw["w_k"], lw["scale"], lw["bias"], **lw["knobs"])
        h = conv((up, skip), f"blk{blk}_conv0")
        if blk < 8 or not head_fuse:
            h = conv(h, f"blk{blk}_conv1")
    lw = qparams["head"]
    if head_fuse:
        return conv(h, "blk8_conv1", head=(lw["w_k"], lw["scale"], lw["bias"]))
    return k3(h, lw["w_k"], lw["scale"], lw["bias"])
