"""Int8 post-training quantization of the U-Net, in plain PyTorch.

1. ``fold_unet_bn``: folds eval BatchNorm into the preceding conv
   (w' = w*g/sqrt(v+eps), b' = beta - mean*g/sqrt(v+eps)).
2. ``folded_forward`` / ``calibrate_unet``: the float32 forward over the
   folded layers, recording per-tensor absmax at every quantization point.
3. ``quantize_unet``: per-output-channel symmetric int8 weights plus the
   calibrated activation scales.
4. ``unet_int8_forward``: the all-int8 graph (int32 accumulation, requant
   ``round((acc*(s_in*s_w) + b)/s_out)`` with two float32 roundings, as the
   JAX package's eager ``_qconv``). It is the port's int8 oracle: the
   served graph (``inference/psrp.py``) is held against it.

Layers are a dict ``{name: {"w", "b"}}`` with names ``blk{i}_conv{j}``
(weights (cout, cin, 3, 3)), ``ct{i}`` ((cin, cout, 2, 2), the
ConvTranspose2d layout) and ``head`` ((nc, cin, 1, 1)). Public functions
take and return NHWC tensors, as the JAX package's do.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from ..models.blocks import BN_EPS
from ..models.unet import BLOCK_PREFIXES, UPCONV_NAMES


# ---------------------------------------------------------------------------
# 1. BN folding
# ---------------------------------------------------------------------------


def fold_unet_bn(model_or_state) -> dict:
    """U-Net module or state dict -> folded layers (float32, on the
    weights' device), in forward order."""
    sd = (model_or_state.state_dict()
          if isinstance(model_or_state, torch.nn.Module) else model_or_state)
    layers = {}
    for i, prefix in enumerate(BLOCK_PREFIXES):
        for j in (0, 1):
            w = sd[f"{prefix}conv{j + 1}.weight"].float()
            bn = f"{prefix}norm{j + 1}"
            # float32 sqrt, correctly rounded (torch's vectorised CPU sqrt
            # is not; rounding the float64 root to float32 is)
            root = torch.sqrt(
                (sd[f"{bn}.running_var"].float() + BN_EPS).double()
            ).float()
            k = sd[f"{bn}.weight"].float() / root
            layers[f"blk{i}_conv{j}"] = {
                "w": w * k[:, None, None, None],
                "b": sd[f"{bn}.bias"].float() - sd[f"{bn}.running_mean"].float() * k,
            }
    for i, name in enumerate(UPCONV_NAMES):
        layers[f"ct{i}"] = {"w": sd[f"{name}.weight"].float(),
                            "b": sd[f"{name}.bias"].float()}
    layers["head"] = {"w": sd["conv.weight"].float(),
                      "b": sd["conv.bias"].float()}
    return layers


# ---------------------------------------------------------------------------
# 2. float forward and calibration
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _full_float32():
    """Run convolutions and matmuls in full float32 (no TF32) on the card."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def folded_forward(layers: dict, x: torch.Tensor, taps: dict | None = None):
    """float32 forward over folded layers: (N, H, W, 1) -> (N, H, W, nc)
    logits. With ``taps``, records the running absmax at every conv and
    transposed-conv input and at the concat outputs."""

    def tap(name, t):
        if taps is not None:
            taps[name] = max(taps.get(name, 0.0), float(t.abs().max()))

    def conv(t, name, relu=True):
        lw = layers[name]
        pad = (lw["w"].shape[-1] - 1) // 2
        y = F.conv2d(t, lw["w"], lw["b"], padding=pad)
        return F.relu(y) if relu else y

    def block(i, t):
        tap(f"blk{i}_conv0_in", t)
        t = conv(t, f"blk{i}_conv0")
        tap(f"blk{i}_conv1_in", t)
        return conv(t, f"blk{i}_conv1")

    with _full_float32(), torch.no_grad():
        h = x.float().permute(0, 3, 1, 2)
        enc = []
        for i in range(4):
            h = block(i, h)
            enc.append(h)
            h = F.max_pool2d(h, 2)
        h = block(4, h)
        for ct, (blk, skip) in enumerate(zip((5, 6, 7, 8), (3, 2, 1, 0))):
            tap(f"ct{ct}_in", h)
            lw = layers[f"ct{ct}"]
            h = F.conv_transpose2d(h, lw["w"], lw["b"], stride=2)
            h = torch.cat([h, enc[skip]], dim=1)
            tap(f"blk{blk}_cat", h)
            h = block(blk, h)
        tap("head_in", h)
        return conv(h, "head", relu=False).permute(0, 2, 3, 1)


def calibrate_unet(layers: dict, sample_batches) -> dict[str, float]:
    """Per-tensor absmax at each quantization point over the batches."""
    dev = layers["head"]["w"].device
    taps: dict[str, float] = {}
    for xb in sample_batches:
        folded_forward(layers, torch.as_tensor(xb, dtype=torch.float32,
                                               device=dev), taps)
    return taps


# ---------------------------------------------------------------------------
# 3. quantization
# ---------------------------------------------------------------------------


def _out_dims(name: str) -> tuple[int, ...]:
    """Reduction dims of a per-output-channel absmax for a layer's weights."""
    return (0, 2, 3) if name.startswith("ct") else (1, 2, 3)


def quant_weights(w: torch.Tensor, name: str, lim: int = 127):
    """float32 weights -> (int8 weights in [-lim, lim], per-out-channel
    float32 scale absmax/lim); ``lim`` is 127, or 7 for 4-bit weights."""
    amax = w.abs().amax(dim=_out_dims(name))
    # divide by a tensor, not a Python scalar: on CUDA torch turns division
    # by a scalar into a multiply by its reciprocal, which is 1 ulp off
    s_w = (amax / amax.new_full((), float(lim))).clamp_min(1e-12)
    shape = [1] * w.dim()
    shape[1 if name.startswith("ct") else 0] = -1
    w_q = torch.round(w / s_w.view(shape)).clamp(-lim, lim).to(torch.int8)
    return w_q, s_w


def quantize_unet(layers: dict, taps: dict) -> dict:
    """-> qparams ``{name: {"w_q", "s_w", "b"}, "_act_scales": {key: s}}``;
    activation scales are 0-d float32 tensors, absmax/127."""
    q = {}
    for name, lw in layers.items():
        w_q, s_w = quant_weights(lw["w"], name)
        q[name] = {"w_q": w_q, "s_w": s_w, "b": lw["b"]}
    dev = layers["head"]["w"].device
    q["_act_scales"] = {
        key: torch.tensor(max(absmax, 1e-12) / 127.0, dtype=torch.float32,
                          device=dev)
        for key, absmax in taps.items()
    }
    return q


# ---------------------------------------------------------------------------
# 4. the all-int8 graph (oracle)
# ---------------------------------------------------------------------------


def _chan(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _qconv(xq, s_in, layer, s_out, *, relu=True, transpose=False):
    """int8 NCHW conv, int32-exact accumulation (float64 products), then
    the requant with two float32 roundings: ``(acc*(s_in*s_w) + b)/s_out``.
    Returns int8 at scale ``s_out``, or the float32 values when ``s_out``
    is None."""
    w = layer["w_q"].double()
    if transpose:
        acc = F.conv_transpose2d(xq.double(), w, stride=2)
    else:
        acc = F.conv2d(xq.double(), w, padding=(w.shape[-1] - 1) // 2)
    y = acc.float() * _chan(s_in * layer["s_w"]) + _chan(layer["b"])
    if s_out is None:
        return y
    y = y / s_out
    return torch.round(y).clamp(0 if relu else -127, 127).to(torch.int8)


def _requant(xq, s_from, s_to):
    return torch.round(xq.float() * (s_from / s_to)).clamp(-127, 127).to(
        torch.int8
    )


def _pool(xq):
    n, c, h, w = xq.shape
    return xq[:, :, : h // 2 * 2, : w // 2 * 2].reshape(
        n, c, h // 2, 2, w // 2, 2
    ).amax(dim=(3, 5))


def unet_int8_forward(qparams: dict, x: torch.Tensor) -> torch.Tensor:
    """All-int8 U-Net: (N, H, W, 1) float -> (N, H, W, nc) float32 logits."""
    s = qparams["_act_scales"]
    h = x.float().permute(0, 3, 1, 2)
    hq = torch.round(h / s["blk0_conv0_in"]).clamp(-127, 127).to(torch.int8)
    enc = []
    for i in range(4):
        hq = _qconv(hq, s[f"blk{i}_conv0_in"], qparams[f"blk{i}_conv0"],
                    s[f"blk{i}_conv1_in"])
        nxt = f"blk{i + 1}_conv0_in"
        hq = _qconv(hq, s[f"blk{i}_conv1_in"], qparams[f"blk{i}_conv1"],
                    s[nxt])
        enc.append((hq, s[nxt]))
        hq = _pool(hq)
    hq = _qconv(hq, s["blk4_conv0_in"], qparams["blk4_conv0"],
                s["blk4_conv1_in"])
    hq = _qconv(hq, s["blk4_conv1_in"], qparams["blk4_conv1"], s["ct0_in"])
    hs = s["ct0_in"]
    for ct, (blk, skip) in enumerate(zip((5, 6, 7, 8), (3, 2, 1, 0))):
        cat_s = s[f"blk{blk}_cat"]
        up = _qconv(hq, hs, qparams[f"ct{ct}"], cat_s, relu=False,
                    transpose=True)
        sk_q, sk_s = enc[skip]
        hq = torch.cat([up, _requant(sk_q, sk_s, cat_s)], dim=1)
        hq = _qconv(hq, cat_s, qparams[f"blk{blk}_conv0"],
                    s[f"blk{blk}_conv1_in"])
        nxt = f"ct{ct + 1}_in" if ct < 3 else "head_in"
        hq = _qconv(hq, s[f"blk{blk}_conv1_in"], qparams[f"blk{blk}_conv1"],
                    s[nxt])
        hs = s[nxt]
    y = _qconv(hq, s["head_in"], qparams["head"], None, relu=False)
    return y.permute(0, 2, 3, 1)
