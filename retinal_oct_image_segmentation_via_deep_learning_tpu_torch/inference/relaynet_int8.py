"""Int8 post-training quantization of ReLayNet, in plain PyTorch (the JAX
package's ``inference/relaynet_int8.py``).

The U-Net's recipe (``inference/quantized.py``) with ReLayNet's pieces:

1. ``fold_relaynet_bn``: eval BatchNorm folded into each block's 7x3 conv,
   its bias included: w' = w*k, b' = beta + (b - mean)*k, k = g/sqrt(v+eps).
2. ``relaynet_folded_forward`` / ``calibrate_relaynet``: the float32 forward
   over the folded layers, recording the absmax of the image ("in") and of
   each block's output ("b{i}_out").
3. ``quantize_relaynet``: per-output-channel symmetric int8 weights. A
   decoder's input ``cat([skip, unpooled])`` is quantized at the unpooled
   half's scale; the skip half arrives at its own scale, so its ratio is
   folded into that half of the weights before they are quantized, and the
   skip feeds the conv raw.
4. ``relaynet_int8_forward``: the all-int8 graph, the port's int8 oracle for
   the served graph (``inference/relaynet_psrp.py``). Its requant is
   ``round(prelu(acc*(s_in*s_w) + b) / s_out)`` in float32 with each
   operation rounded on its own, as the JAX package's eager graph computes
   it. The PReLU comes before the requant; it is monotone for a positive
   slope, so pooling on int8 values makes the float graph's decisions up
   to requant ties.

Layers are ``{"b{i}": {"w", "b", "alpha"}, "head": {"w", "b"}}`` with
torch-layout weights ((cout, cin, 7, 3); the head's (nc, f, 1, 1)) and a
0-d float32 ``alpha``. Public functions take and return NHWC tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.blocks import BN_EPS
from ..models.relaynet import BLOCK_NAMES
from ..ops.pooling import max_pool_argmax, max_unpool
from .quantized import _full_float32, quant_weights

NBLOCKS = len(BLOCK_NAMES)  # 3 encoders, bottleneck, 3 decoders
# decoder block -> activation key of the skip half of its input
SKIP_KEYS = {"b4": "b2_out", "b5": "b1_out", "b6": "b0_out"}


def fold_relaynet_bn(model_or_state) -> dict:
    """ReLayNet module or state dict -> folded layers (float32, on the
    weights' device)."""
    sd = (model_or_state.state_dict()
          if isinstance(model_or_state, torch.nn.Module) else model_or_state)
    layers = {}
    for i, name in enumerate(BLOCK_NAMES):
        bn = f"{name}.norm"
        # the float64 root rounded to float32 is correctly rounded (torch's
        # vectorised CPU sqrt is not)
        root = torch.sqrt(
            (sd[f"{bn}.running_var"].float() + BN_EPS).double()
        ).float()
        k = sd[f"{bn}.weight"].float() / root
        cb = sd[f"{name}.conv.bias"].float()
        layers[f"b{i}"] = {
            "w": sd[f"{name}.conv.weight"].float() * k[:, None, None, None],
            "b": sd[f"{bn}.bias"].float()
            + (cb - sd[f"{bn}.running_mean"].float()) * k,
            "alpha": sd[f"{name}.prelu.weight"].float().reshape(()),
        }
    layers["head"] = {"w": sd["classifier.weight"].float(),
                      "b": sd["classifier.bias"].float()}
    return layers


def _conv(x: torch.Tensor, w: torch.Tensor, b=None) -> torch.Tensor:
    """NHWC stride-1 'same' conv with OIHW weights."""
    pad = ((w.shape[2] - 1) // 2, (w.shape[3] - 1) // 2)
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=pad).permute(
        0, 2, 3, 1)


def _prelu(y: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return torch.where(y >= 0, y, alpha * y)


def relaynet_folded_forward(layers: dict, x: torch.Tensor,
                            taps: dict | None = None) -> torch.Tensor:
    """float32 forward over folded layers: (N, H, W, 1) -> (N, H, W, nc)
    logits. With ``taps``, records the running absmax of the image ("in")
    and of each block's output ("b{i}_out")."""

    def tap(key, t):
        if taps is not None:
            taps[key] = max(taps.get(key, 0.0), float(t.abs().max()))
        return t

    def block(i, t):
        lw = layers[f"b{i}"]
        return tap(f"b{i}_out", _prelu(_conv(t, lw["w"], lw["b"]),
                                       lw["alpha"]))

    with _full_float32(), torch.no_grad():
        h = tap("in", x.float())
        skips, idxs = [], []
        for i in range(3):
            s = block(i, h)
            h, idx = max_pool_argmax(s)
            skips.append(s)
            idxs.append(idx)
        h = block(3, h)
        for j, (s, idx) in enumerate(zip(reversed(skips), reversed(idxs))):
            h = block(4 + j, torch.cat([s, max_unpool(h, idx)], dim=-1))
        return _conv(h, layers["head"]["w"], layers["head"]["b"])


def calibrate_relaynet(layers: dict, sample_batches) -> dict[str, float]:
    """Per-tensor absmax at each quantization point over the batches."""
    dev = layers["head"]["w"].device
    taps: dict[str, float] = {}
    for xb in sample_batches:
        relaynet_folded_forward(
            layers, torch.as_tensor(xb, dtype=torch.float32, device=dev),
            taps)
    return taps


def _input_scales(s: dict) -> dict:
    """The activation scale of each block's conv input (pool, unpool and
    cat keep their inputs' scales; a decoder's is its unpooled half's)."""
    return {"b0": s["in"], "b1": s["b0_out"], "b2": s["b1_out"],
            "b3": s["b2_out"], "b4": s["b3_out"], "b5": s["b4_out"],
            "b6": s["b5_out"]}


def quantize_relaynet(layers: dict, taps: dict) -> dict:
    """-> qparams ``{"b{i}": {"w_q", "s_w", "b", "alpha"}, "head": {"w_q",
    "s_w", "b"}, "_act_scales": {key: s}}``; activation scales are 0-d
    float32 tensors, absmax/127, with ``b{i}_in`` for each conv input."""
    dev = layers["head"]["w"].device
    s = {key: torch.tensor(max(absmax, 1e-12) / 127.0, dtype=torch.float32,
                           device=dev)
         for key, absmax in taps.items()}
    s_in = _input_scales(s)
    q = {}
    for i in range(NBLOCKS):
        name = f"b{i}"
        lw = layers[name]
        w = lw["w"]
        if name in SKIP_KEYS:
            w = w.clone()
            w[:, : w.shape[1] // 2] *= s[SKIP_KEYS[name]] / s_in[name]
        w_q, s_w = quant_weights(w, name)
        q[name] = {"w_q": w_q, "s_w": s_w, "b": lw["b"], "alpha": lw["alpha"]}
    w_q, s_w = quant_weights(layers["head"]["w"], "head")
    q["head"] = {"w_q": w_q, "s_w": s_w, "b": layers["head"]["b"]}
    q["_act_scales"] = {**s, **{f"{k}_in": v for k, v in s_in.items()}}
    return q


def _qconv_prelu(xq, s_in, layer, s_out):
    """int8 conv (float64 products, exact), then the float32 epilogue with
    each operation rounded on its own, int8 out."""
    acc = _conv(xq.double(), layer["w_q"].double())
    y = acc.float() * (s_in * layer["s_w"]) + layer["b"]
    y = _prelu(y, layer["alpha"])
    return torch.round(y / s_out).clamp(-127, 127).to(torch.int8)


def relaynet_int8_forward(qparams: dict, x: torch.Tensor) -> torch.Tensor:
    """All-int8 ReLayNet: (N, H, W, 1) float -> (N, H, W, nc) float32
    logits."""
    s = qparams["_act_scales"]
    hq = torch.round(x.float() / s["in"]).clamp(-127, 127).to(torch.int8)
    skips, idxs = [], []
    for i in range(3):
        sq = _qconv_prelu(hq, s[f"b{i}_in"], qparams[f"b{i}"],
                          s[f"b{i}_out"])
        hq, idx = max_pool_argmax(sq)
        skips.append(sq)
        idxs.append(idx)
    hq = _qconv_prelu(hq, s["b3_in"], qparams["b3"], s["b3_out"])
    for j, (sq, idx) in enumerate(zip(reversed(skips), reversed(idxs))):
        # the skip feeds raw int8: its requant is folded into the weights
        cat = torch.cat([sq, max_unpool(hq, idx)], dim=-1)
        name = f"b{4 + j}"
        hq = _qconv_prelu(cat, s[f"{name}_in"], qparams[name],
                          s[f"{name}_out"])
    hw = qparams["head"]
    acc = _conv(hq.double(), hw["w_q"].double())
    return acc.float() * (s["b6_out"] * hw["s_w"]) + hw["b"]
