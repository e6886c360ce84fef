"""Plain reference of the U-Net (``YNet_2022.py:509-602`` of
ZhangHH233/Retinal_OCT_Image_Segmentation_via_Deep_Learning): four encoder
blocks, a bottleneck and four decoder blocks of (3x3 conv without bias,
BatchNorm, ReLU) twice, 2x2/2 max pools, 2x2/2 transposed convs with bias,
skip concats ``[up, skip]``, and a 1x1 head with bias.

* ``train_forward``: the train-mode float forward (batch statistics), NCHW.
* ``int8_labels``: the served int8 graph worked out from the weights and
  the calibration batch: BN folded into the convs, activation absmax
  calibrated on the float32 folded forward, per-output-channel symmetric
  weights, each skip's rescale folded into the skip half of its consumer's
  weights, and every conv's requant ``fmaf(acc, (s_in*s_w)/s_out,
  b/s_out)``, ReLU, round half to even, clip; the head's logits
  ``fmaf(acc, s_in*s_w, b)`` and their argmax.

Parameters are a dict keyed by the module names the reference's state dict
uses (``encoder1.enc1conv1.weight``, ..., ``upconv4.weight``,
``conv.bias``).

As a configuration's reference module it also supplies ``param_spec``,
``forward_ops``, ``train_steps`` and ``STEM`` (``harness.reference``).
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import work
from . import train
from .common import (
    BN_EPS,
    act_scale,
    calibration_images,
    full_float32,
    head_argmax,
    input_levels,
    quant_weights,
    requant,
    round_clip,
    zscore,
)

BLOCKS = ("encoder1.enc1", "encoder2.enc2", "encoder3.enc3", "encoder4.enc4",
          "bottleneck.bottleneck", "decoder4.dec4", "decoder3.dec3",
          "decoder2.dec2", "decoder1.dec1")
UPCONVS = ("upconv4", "upconv3", "upconv2", "upconv1")
# the decoder blocks, the transposed conv that feeds each and its skip
DECODER = ((5, 0, 3), (6, 1, 2), (7, 2, 1), (8, 3, 0))
# the first conv and the BatchNorm after it (``train.first_bn_stats``)
STEM = ("encoder1.enc1conv1.weight", "encoder1.enc1norm1")


def block_channels(f: int, cin: int = 1) -> list[tuple[int, int]]:
    """(in, out) channels of the nine blocks."""
    enc = [(cin, f), (f, 2 * f), (2 * f, 4 * f), (4 * f, 8 * f),
           (8 * f, 16 * f)]
    dec = [(16 * f, 8 * f), (8 * f, 4 * f), (4 * f, 2 * f), (2 * f, f)]
    return enc + dec


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BN buffer; ``kind``:
    "conv3x3", "ct", "head" (weights), "bias", "bn_weight", "bn_bias",
    "bn_mean", "bn_var"."""
    f, nc = cfg["width"], cfg["num_classes"]
    out = []
    for prefix, (cin, cout) in zip(BLOCKS, block_channels(f,
                                                          cfg["in_channels"])):
        for j, c in ((1, cin), (2, cout)):
            out.append((f"{prefix}conv{j}.weight", (cout, c, 3, 3),
                        "conv3x3"))
            for part in ("weight", "bias", "mean", "var"):
                name = {"mean": "running_mean", "var": "running_var"}.get(
                    part, part)
                out.append((f"{prefix}norm{j}.{name}", (cout,),
                            f"bn_{part}"))
    for name, c in zip(UPCONVS, (16 * f, 8 * f, 4 * f, 2 * f)):
        out += [(f"{name}.weight", (c, c // 2, 2, 2), "ct"),
                (f"{name}.bias", (c // 2,), "bias")]
    out += [("conv.weight", (nc, f, 1, 1), "head"), ("conv.bias", (nc,),
                                                     "bias")]
    return out


def forward_ops(cfg: dict) -> float:
    """Operations (2 a multiply-add) of one forward of one B-scan, from
    the layer shapes (``work.unet_forward_ops``)."""
    return work.unet_forward_ops(cfg["width"], cfg["image_size"],
                                 cfg["num_classes"])


def train_steps(p: dict, batches, lr: float, cast=None) -> dict:
    """``train.train_steps`` on this module's ``train_forward``."""
    return train.train_steps(sys.modules[__name__], p, batches, lr, cast)


def trainable(name: str) -> bool:
    """Whether ``name`` is a parameter (the BN running statistics are
    buffers)."""
    return "running_" not in name


# ---------------------------------------------------------------------------
# train-mode float forward
# ---------------------------------------------------------------------------


def train_forward(p: dict, x: torch.Tensor, *, stat_sum=None,
                  ranks: int = 1, cast=None):
    """Train-mode forward of (N, 1, H, W) float32 images -> (logits (N, nc,
    H, W), {BN name: (batch mean, biased batch var)}). ``stat_sum`` sums
    a statistic over the ``ranks`` data-parallel ranks (identity on one),
    each holding a block of the batch of the same size, and ``cast`` rounds each conv's inputs and weights (the lower-precision
    control); none by default."""
    gsum = stat_sum or (lambda t: t)
    cast = cast or (lambda t: t)
    stats = {}

    def bn(y, name):
        m = y.shape[0] * y.shape[2] * y.shape[3] * ranks
        mean = gsum(y.sum(dim=(0, 2, 3))) / m
        d = y - mean.view(1, -1, 1, 1)
        var = gsum((d * d).sum(dim=(0, 2, 3))) / m
        stats[name] = (mean.detach(), var.detach())
        out = d * torch.rsqrt(var + BN_EPS).view(1, -1, 1, 1)
        return out * p[f"{name}.weight"].view(1, -1, 1, 1) + \
            p[f"{name}.bias"].view(1, -1, 1, 1)

    def body(h, i):
        prefix = BLOCKS[i]
        for j in (1, 2):
            y = F.conv2d(cast(h), cast(p[f"{prefix}conv{j}.weight"]),
                         padding=1)
            h = torch.relu(bn(y, f"{prefix}norm{j}"))
        return h

    def block(h, i):
        # each block recomputed in the backward: the float32 activations
        # of a whole batch at 512^2 would not fit beside each other
        if torch.is_grad_enabled():
            return checkpoint(body, h, i, use_reentrant=False)
        return body(h, i)

    enc = []
    h = x
    for i in range(4):
        h = block(h, i)
        enc.append(h)
        h = F.max_pool2d(h, 2)
    h = block(h, 4)
    for blk, ct, skip in DECODER:
        up = F.conv_transpose2d(cast(h), cast(p[f"{UPCONVS[ct]}.weight"]),
                                p[f"{UPCONVS[ct]}.bias"], stride=2)
        h = block(torch.cat([up, enc[skip]], dim=1), blk)
    logits = F.conv2d(cast(h), cast(p["conv.weight"]), p["conv.bias"])
    return logits, stats


# ---------------------------------------------------------------------------
# the served int8 graph
# ---------------------------------------------------------------------------


def fold(p: dict) -> dict:
    """Eval BatchNorm folded into each 3x3 conv: {"blk{i}_conv{j}": {"w",
    "b"}, "ct{k}": ..., "head": ...}, float32."""
    layers = {}
    for i, prefix in enumerate(BLOCKS):
        for j in (0, 1):
            bn = f"{prefix}norm{j + 1}"
            # the float64 root rounded to float32 (correctly rounded)
            root = torch.sqrt((p[f"{bn}.running_var"].float()
                               + BN_EPS).double()).float()
            k = p[f"{bn}.weight"].float() / root
            layers[f"blk{i}_conv{j}"] = {
                "w": p[f"{prefix}conv{j + 1}.weight"].float()
                * k[:, None, None, None],
                "b": p[f"{bn}.bias"].float()
                - p[f"{bn}.running_mean"].float() * k,
            }
    for k, name in enumerate(UPCONVS):
        layers[f"ct{k}"] = {"w": p[f"{name}.weight"].float(),
                            "b": p[f"{name}.bias"].float()}
    layers["head"] = {"w": p["conv.weight"].float(),
                      "b": p["conv.bias"].float()}
    return layers


def calibrate(layers: dict, x: torch.Tensor) -> dict[str, float]:
    """Absmax of every quantised tensor in the float32 folded forward of
    the z-scored (N, H, W, 1) batch ``x``: each conv's and transposed
    conv's input, each concat's output, the head's input."""
    taps: dict[str, float] = {}

    def tap(key, t):
        taps[key] = max(taps.get(key, 0.0), float(t.abs().max()))

    def conv(t, name):
        lw = layers[name]
        return F.relu(F.conv2d(t, lw["w"], lw["b"], padding=1))

    def block(i, t):
        tap(f"blk{i}_conv0_in", t)
        t = conv(t, f"blk{i}_conv0")
        tap(f"blk{i}_conv1_in", t)
        return conv(t, f"blk{i}_conv1")

    with full_float32(), torch.no_grad():
        h = x.float().permute(0, 3, 1, 2)
        enc = []
        for i in range(4):
            h = block(i, h)
            enc.append(h)
            h = F.max_pool2d(h, 2)
        h = block(4, h)
        for blk, ct, skip in DECODER:
            tap(f"ct{ct}_in", h)
            lw = layers[f"ct{ct}"]
            h = F.conv_transpose2d(h, lw["w"], lw["b"], stride=2)
            h = torch.cat([h, enc[skip]], dim=1)
            tap(f"blk{blk}_cat", h)
            h = block(blk, h)
        tap("head_in", h)
    return taps


def _keys(i: int, j: int) -> tuple[str, str]:
    """(input, output) activation keys of blk{i}_conv{j}."""
    if j == 0:
        return (f"blk{i}_cat" if i >= 5 else f"blk{i}_conv0_in",
                f"blk{i}_conv1_in")
    nxt = {4: "ct0_in", 5: "ct1_in", 6: "ct2_in", 7: "ct3_in",
           8: "head_in"}.get(i, f"blk{i + 1}_conv0_in")
    return f"blk{i}_conv1_in", nxt


def quantize(layers: dict, taps: dict, lim: int = 127) -> dict:
    """Integer weights and each layer's epilogue (``scale``, ``bias``)."""
    dev = layers["head"]["w"].device
    s = {key: act_scale(v, lim, dev) for key, v in taps.items()}
    q = {"_s": s}
    for i in range(9):
        for j in (0, 1):
            name = f"blk{i}_conv{j}"
            in_key, out_key = _keys(i, j)
            w = layers[name]["w"]
            if i >= 5 and j == 0:
                # the skip (second half) arrives at its producer's scale
                skip_key = f"blk{DECODER[i - 5][2] + 1}_conv0_in"
                w = w.clone()
                w[:, w.shape[1] // 2:] *= s[skip_key] / s[f"blk{i}_cat"]
            w_q, s_w = quant_weights(w, 0, lim)
            q[name] = {"w": w_q, "scale": s[in_key] * s_w / s[out_key],
                       "bias": layers[name]["b"] / s[out_key]}
    for k in range(4):
        name = f"ct{k}"
        w_q, s_w = quant_weights(layers[name]["w"], 1, lim)
        s_out = s[f"blk{k + 5}_cat"]
        q[name] = {"w": w_q, "scale": s[f"ct{k}_in"] * s_w / s_out,
                   "bias": layers[name]["b"] / s_out}
    w_q, s_w = quant_weights(layers["head"]["w"], 0, lim)
    q["head"] = {"w": w_q, "scale": s["head_in"] * s_w,
                 "bias": layers["head"]["b"]}
    return q


def int8_graph(q: dict, x: torch.Tensor, lim: int = 127) -> torch.Tensor:
    """z-scored (N, H, W, 1) float32 images -> (N, H, W) int8 labels."""

    def conv(h, name):
        lw = q[name]
        v = requant(F.conv2d(h, lw["w"], padding=1), lw["scale"], lw["bias"])
        return round_clip(v.clamp_min(0.0), lim)

    def ct(h, name):
        lw = q[name]
        acc = F.conv_transpose2d(h, lw["w"], stride=2)
        return round_clip(requant(acc, lw["scale"], lw["bias"]), lim)

    h = input_levels(x, q["_s"]["blk0_conv0_in"], lim)
    skips = []
    for i in range(4):
        y = conv(conv(h, f"blk{i}_conv0"), f"blk{i}_conv1")
        skips.append(y)
        h = F.max_pool2d(y, 2)
    h = conv(conv(h, "blk4_conv0"), "blk4_conv1")
    for blk, k, skip in DECODER:
        h = conv(torch.cat([ct(h, f"ct{k}"), skips[skip]], dim=1),
                 f"blk{blk}_conv0")
        h = conv(h, f"blk{blk}_conv1")
    hw = q["head"]
    return head_argmax(h, hw["w"], hw["scale"], hw["bias"])


def prepare_int8(p: dict, image_size: int, calib_seed: int, device,
                 lim: int = 127) -> dict:
    """Fold, calibrate on the seeded calibration batch, quantise."""
    layers = fold({k: v.to(device) for k, v in p.items()})
    taps = calibrate(layers, calibration_images(image_size, calib_seed,
                                                device))
    return quantize(layers, taps, lim)


@torch.no_grad()
def int8_labels(q: dict, images: torch.Tensor, lim: int = 127,
                block: int = 8) -> torch.Tensor:
    """(N, H, W) uint8 grey-level B-scans on the device -> (N, H, W) int8
    labels, ``block`` B-scans at a time."""
    out = []
    for i in range(0, images.shape[0], block):
        x = zscore(images[i:i + block].float().unsqueeze(-1))
        out.append(int8_graph(q, x, lim))
    return torch.cat(out)
