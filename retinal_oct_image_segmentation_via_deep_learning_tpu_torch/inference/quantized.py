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
5. ``quantize_unet_mixed`` / ``unet_mixed_forward``: the mixed graph, its
   shallow stages in bf16 or int8 and its deep region (blk2..blk6, ct0,
   ct1) in int8, the ten deep 3x3 convs on K1 (``ops/conv_int8``).

Under ``parallel.halo.spatial_partitioning`` every 3x3 ``_qconv`` first
takes its padding rows from its neighbours in H (zeros at the image's
border), as the JAX package's does.

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
from ..ops.conv_int8 import (
    conv3x3_int8,
    pack_conv3x3_mma_weights,
    pack_conv3x3_weights,
)
from ..parallel.halo import current_spatial_axis, halo_exchange


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
        # k = s = 2: each output row reads one input row, a local op under
        # spatial partitioning
        acc = F.conv_transpose2d(xq.double(), w, stride=2)
    else:
        pad = (w.shape[-1] - 1) // 2
        padding = (pad, pad)
        if pad and current_spatial_axis() is not None:
            xq = halo_exchange(xq, pad, current_spatial_axis(), dim=2)
            padding = (0, pad)
        acc = F.conv2d(xq.double(), w, padding=padding)
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


# ---------------------------------------------------------------------------
# 5. the mixed graph (JAX ``inference/quantized.py:222-380``)
# ---------------------------------------------------------------------------

# the deep region: everything between pool(blk1) and ct2's input
DEEP_BLOCKS = (2, 3, 4, 5, 6)
DEEP_STAGES = tuple(f"blk{i}_conv{j}" for i in DEEP_BLOCKS for j in (0, 1))
# ``deep``: "pallas" (JAX's name for its kernel route) runs the ten deep
# 3x3 convs on K1, "xla" on ``_qconv`` as JAX's graph does off the TPU
DEEP_IMPLS = ("pallas", "xla")
SHALLOW_MODES = ("bf16", "int8")


def quantize_unet_mixed(layers: dict, taps: dict) -> dict:
    """qparams of ``unet_mixed_forward``: ``quantize_unet``'s, the deep
    3x3 convs' weights also in K1's orders (``w_k``, ``w_m``, packed once
    here), and every layer's folded weights in bf16 (``w_bf16``) with its
    float32 bias (``b_f32``) for the bf16 shallow stages."""
    q = quantize_unet(layers, taps)
    for name in DEEP_STAGES:
        lw = q[name]
        lw["w_k"] = pack_conv3x3_weights(lw["w_q"])
        lw["w_m"] = pack_conv3x3_mma_weights(lw["w_q"])
    for name, lw in layers.items():
        q[name]["w_bf16"] = lw["w"].to(torch.bfloat16)
        q[name]["b_f32"] = lw["b"].float()
    return q


def _bconv(layer, x, relu=True, transpose=False):
    """bf16 conv (bf16 out, as XLA's), then the bias added in bf16."""
    w = layer["w_bf16"]
    if transpose:
        y = F.conv_transpose2d(x, w, stride=2)
    else:
        y = F.conv2d(x, w, padding=(w.shape[-1] - 1) // 2)
    y = y + layer["b_f32"].to(y.dtype).view(1, -1, 1, 1)
    return F.relu(y) if relu else y


def _quant_in(h, s):
    return torch.round(h.float() / s).clamp(-127, 127).to(torch.int8)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).contiguous()


def unet_mixed_forward(qparams: dict, x: torch.Tensor, *,
                       shallow: str = "bf16",
                       deep: str = "pallas") -> torch.Tensor:
    """The mixed U-Net: (N, H, W, 1) float -> (N, H, W, nc) logits, bf16
    for ``shallow="bf16"``, float32 for ``"int8"``.

    Shallow stages (blk0/1, ct2/3 + blk7/8, the head) run in ``shallow``
    precision: bf16 convs of the folded weights, or ``_qconv``. The deep
    region runs int8; with ``deep="pallas"`` its ten 3x3 convs are K1 with
    the epilogue ``fmaf(acc, (s_in*s_w)/s_out, b/s_out)`` (one rounding,
    as JAX's Pallas route), with ``deep="xla"`` they are ``_qconv`` (two
    roundings, JAX's graph off the TPU). ct0/ct1 are ``_qconv`` in both."""
    if shallow not in SHALLOW_MODES:
        raise ValueError(f"shallow={shallow!r}: one of {SHALLOW_MODES}")
    if deep not in DEEP_IMPLS:
        raise ValueError(f"deep={deep!r}: one of {DEEP_IMPLS}")
    s = qparams["_act_scales"]

    def dconv(inputs, in_key, name, out_key, pool=False):
        """A deep 3x3 conv over the channel concat of ``inputs`` (NCHW
        int8); with ``pool`` also its 2x2 max-pool."""
        layer = qparams[name]
        s_in, s_out = s[in_key], s[out_key]
        if deep == "xla":
            y = _qconv(torch.cat(inputs, dim=1) if len(inputs) > 1
                       else inputs[0], s_in, layer, s_out)
            return (y, _pool(y)) if pool else y
        scale = ((s_in * layer["s_w"]) / s_out).contiguous()
        bias = (layer["b"] / s_out).contiguous()
        out = conv3x3_int8(tuple(_nhwc(t) for t in inputs), layer["w_k"],
                           scale, bias, pool=pool, w_mma=layer["w_m"])
        if pool:
            return tuple(t.permute(0, 3, 1, 2) for t in out)
        return out.permute(0, 3, 1, 2)

    h = x.permute(0, 3, 1, 2)
    if shallow == "bf16":
        h = h.to(torch.bfloat16)
        enc = []
        for i in (0, 1):
            h = _bconv(qparams[f"blk{i}_conv0"], h)
            h = _bconv(qparams[f"blk{i}_conv1"], h)
            enc.append(h)
            h = _pool(h)
        hq = _quant_in(h, s["blk2_conv0_in"])
    else:
        hq = _quant_in(h, s["blk0_conv0_in"])
        enc = []
        for i in (0, 1):
            hq = _qconv(hq, s[f"blk{i}_conv0_in"], qparams[f"blk{i}_conv0"],
                        s[f"blk{i}_conv1_in"])
            nxt = f"blk{i + 1}_conv0_in"
            hq = _qconv(hq, s[f"blk{i}_conv1_in"], qparams[f"blk{i}_conv1"],
                        s[nxt])
            enc.append((hq, s[nxt]))
            hq = _pool(hq)

    # the int8 deep region: blk2 -> blk3 -> blk4 -> ct0 -> blk5 -> ct1 -> blk6
    deep_enc = []
    for i in (2, 3):
        hq = dconv((hq,), f"blk{i}_conv0_in", f"blk{i}_conv0",
                   f"blk{i}_conv1_in")
        nxt = f"blk{i + 1}_conv0_in"
        hq, pooled = dconv((hq,), f"blk{i}_conv1_in", f"blk{i}_conv1", nxt,
                           pool=True)
        deep_enc.append((hq, s[nxt]))
        hq = pooled
    hq = dconv((hq,), "blk4_conv0_in", "blk4_conv0", "blk4_conv1_in")
    hq = dconv((hq,), "blk4_conv1_in", "blk4_conv1", "ct0_in")
    hs = s["ct0_in"]
    for ct, blk in ((0, 5), (1, 6)):
        cat_s = s[f"blk{blk}_cat"]
        up = _qconv(hq, hs, qparams[f"ct{ct}"], cat_s, relu=False,
                    transpose=True)
        sk_q, sk_s = deep_enc[1 - ct]
        hq = dconv((up, _requant(sk_q, sk_s, cat_s)), f"blk{blk}_cat",
                   f"blk{blk}_conv0", f"blk{blk}_conv1_in")
        nxt = f"ct{ct + 1}_in"
        hq = dconv((hq,), f"blk{blk}_conv1_in", f"blk{blk}_conv1", nxt)
        hs = s[nxt]

    if shallow == "bf16":
        h = hq.to(torch.bfloat16) * hs.to(torch.bfloat16)
        for ct, blk, skip in ((2, 7, enc[1]), (3, 8, enc[0])):
            h = _bconv(qparams[f"ct{ct}"], h, relu=False, transpose=True)
            h = torch.cat([h, skip], dim=1)
            h = _bconv(qparams[f"blk{blk}_conv0"], h)
            h = _bconv(qparams[f"blk{blk}_conv1"], h)
        return _bconv(qparams["head"], h, relu=False).permute(0, 2, 3, 1)
    for ct, blk, skip in ((2, 7, 1), (3, 8, 0)):
        cat_s = s[f"blk{blk}_cat"]
        up = _qconv(hq, hs, qparams[f"ct{ct}"], cat_s, relu=False,
                    transpose=True)
        sk_q, sk_s = enc[skip]
        hq = torch.cat([up, _requant(sk_q, sk_s, cat_s)], dim=1)
        hq = _qconv(hq, cat_s, qparams[f"blk{blk}_conv0"],
                    s[f"blk{blk}_conv1_in"])
        nxt = "ct3_in" if ct == 2 else "head_in"
        hq = _qconv(hq, s[f"blk{blk}_conv1_in"], qparams[f"blk{blk}_conv1"],
                    s[nxt])
        hs = s[nxt]
    y = _qconv(hq, s["head_in"], qparams["head"], None, relu=False)
    return y.permute(0, 2, 3, 1)
