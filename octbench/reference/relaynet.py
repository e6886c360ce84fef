"""Plain reference of ReLayNet (Roy et al. 2017, arXiv:1704.02161): three
encoder blocks, a bottleneck and three decoder blocks, each a 7x3 conv with
bias (padding (3, 1)), BatchNorm and a PReLU of one slope; the encoders
max-pool 2x2/2 keeping the window index of each maximum, each decoder
unpools to those indices and convolves ``[skip, unpooled]``; a 1x1 head.

``int8_labels`` runs the served int8 graph worked out from the weights and
the calibration batch: BN folded into each conv (its bias too), absmax
calibrated on the float32 folded forward at the image and at each block's
output, per-output-channel symmetric weights with each skip's rescale
folded into the skip half of its decoder's weights, and each conv's
requant ``fmaf(acc, (s_in*s_w)/s_out, b/s_out)``, the PReLU on that value,
round half to even, clip; pools on the integer values (the first maximum
of a window in the order dy*2 + dx); the head as the U-Net's.

As a configuration's reference module it also supplies ``param_spec`` and
``forward_ops`` (``harness.reference``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import work
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

BLOCKS = ("encode1", "encode2", "encode3", "bottleneck", "decode1",
          "decode2", "decode3")
KERNEL = (7, 3)
PAD = (3, 1)


def param_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter and BN buffer; ``kind`` as
    ``unet.param_spec``'s, with "conv7x3" and "prelu"."""
    f, nc = cfg["width"], cfg["num_classes"]
    cins = (cfg["in_channels"], f, f, f, 2 * f, 2 * f, 2 * f)
    out = []
    for name, cin in zip(BLOCKS, cins):
        out += [(f"{name}.conv.weight", (f, cin) + KERNEL, "conv7x3"),
                (f"{name}.conv.bias", (f,), "bias"),
                (f"{name}.norm.weight", (f,), "bn_weight"),
                (f"{name}.norm.bias", (f,), "bn_bias"),
                (f"{name}.norm.running_mean", (f,), "bn_mean"),
                (f"{name}.norm.running_var", (f,), "bn_var"),
                (f"{name}.prelu.weight", (1,), "prelu")]
    out += [("classifier.weight", (nc, f, 1, 1), "head"),
            ("classifier.bias", (nc,), "bias")]
    return out


def forward_ops(cfg: dict) -> float:
    """Operations (2 a multiply-add) of one forward of one B-scan, from
    the layer shapes (``work.relaynet_forward_ops``)."""
    return work.relaynet_forward_ops(cfg["width"], cfg["image_size"],
                                     cfg["num_classes"])


def _pool_argmax(y: torch.Tensor):
    """2x2/2 max-pool of (N, C, H, W) values -> (pooled, window index of
    the first maximum in the order dy*2 + dx)."""
    n, c, h, w = y.shape
    win = y.reshape(n, c, h // 2, 2, w // 2, 2).permute(0, 1, 2, 4, 3, 5)
    win = win.reshape(n, c, h // 2, w // 2, 4)
    return win.amax(dim=-1), win.argmax(dim=-1)


def _unpool(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Each value at its window index, zeros elsewhere."""
    n, c, h, w = x.shape
    slots = torch.arange(4, device=x.device).view(1, 1, 1, 1, 4)
    win = torch.where(slots == idx.unsqueeze(-1), x.unsqueeze(-1),
                      torch.zeros((), dtype=x.dtype, device=x.device))
    win = win.reshape(n, c, h, w, 2, 2).permute(0, 1, 2, 4, 3, 5)
    return win.reshape(n, c, 2 * h, 2 * w)


def fold(p: dict) -> dict:
    """Eval BatchNorm folded into each conv: {"b{i}": {"w", "b",
    "alpha"}, "head": {"w", "b"}}, float32."""
    layers = {}
    for i, name in enumerate(BLOCKS):
        bn = f"{name}.norm"
        root = torch.sqrt((p[f"{bn}.running_var"].float()
                           + BN_EPS).double()).float()
        k = p[f"{bn}.weight"].float() / root
        layers[f"b{i}"] = {
            "w": p[f"{name}.conv.weight"].float() * k[:, None, None, None],
            "b": p[f"{bn}.bias"].float()
            + (p[f"{name}.conv.bias"].float()
               - p[f"{bn}.running_mean"].float()) * k,
            "alpha": p[f"{name}.prelu.weight"].float().reshape(()),
        }
    layers["head"] = {"w": p["classifier.weight"].float(),
                      "b": p["classifier.bias"].float()}
    return layers


def _prelu(y, alpha):
    return torch.where(y >= 0, y, alpha * y)


def calibrate(layers: dict, x: torch.Tensor) -> dict[str, float]:
    """Absmax of the z-scored image ("in") and of each block's output
    ("b{i}_out") in the float32 folded forward."""
    taps: dict[str, float] = {}

    def tap(key, t):
        taps[key] = max(taps.get(key, 0.0), float(t.abs().max()))
        return t

    def block(i, t):
        # channels-last input, as a conv of NHWC activations gets it
        lw = layers[f"b{i}"]
        y = F.conv2d(t.contiguous(memory_format=torch.channels_last),
                     lw["w"], lw["b"], padding=PAD)
        return tap(f"b{i}_out", _prelu(y, lw["alpha"]))

    with full_float32(), torch.no_grad():
        h = tap("in", x.float()).permute(0, 3, 1, 2)
        skips, idxs = [], []
        for i in range(3):
            s = block(i, h)
            h, idx = _pool_argmax(s)
            skips.append(s)
            idxs.append(idx)
        h = block(3, h)
        for j in range(3):
            h = block(4 + j, torch.cat([skips[2 - j],
                                        _unpool(h, idxs[2 - j])], dim=1))
    return taps


def quantize(layers: dict, taps: dict, lim: int = 127) -> dict:
    """Integer weights and each block's epilogue."""
    dev = layers["head"]["w"].device
    s = {key: act_scale(v, lim, dev) for key, v in taps.items()}
    s_in = [s["in"]] + [s[f"b{i}_out"] for i in range(6)]
    q = {"_s": s}
    for i in range(7):
        lw = layers[f"b{i}"]
        w = lw["w"]
        if i >= 4:
            # the skip (first half) arrives at its encoder's scale
            w = w.clone()
            w[:, : w.shape[1] // 2] *= s[f"b{6 - i}_out"] / s_in[i]
        w_q, s_w = quant_weights(w, 0, lim)
        s_out = s[f"b{i}_out"]
        q[f"b{i}"] = {"w": w_q, "scale": s_in[i] * s_w / s_out,
                      "bias": lw["b"] / s_out, "alpha": lw["alpha"]}
    w_q, s_w = quant_weights(layers["head"]["w"], 0, lim)
    q["head"] = {"w": w_q, "scale": s["b6_out"] * s_w,
                 "bias": layers["head"]["b"]}
    return q


def int8_graph(q: dict, x: torch.Tensor, lim: int = 127) -> torch.Tensor:
    """z-scored (N, H, W, 1) float32 images -> (N, H, W) int8 labels."""

    def conv(h, i):
        lw = q[f"b{i}"]
        v = requant(F.conv2d(h, lw["w"], padding=PAD), lw["scale"],
                    lw["bias"])
        return round_clip(_prelu(v, lw["alpha"]), lim)

    h = input_levels(x, q["_s"]["in"], lim)
    skips, idxs = [], []
    for i in range(3):
        y = conv(h, i)
        h, idx = _pool_argmax(y)
        skips.append(y)
        idxs.append(idx)
    h = conv(h, 3)
    for j in range(3):
        h = conv(torch.cat([skips[2 - j], _unpool(h, idxs[2 - j])], dim=1),
                 4 + j)
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
