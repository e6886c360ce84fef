"""JAX U-Net and ReLayNet weights <-> this package's state dicts (and JAX
int8 qparams -> this package's qparams).

Inputs are numpy arrays (or anything ``np.asarray`` takes); nothing of JAX
is imported. The reverse direction, ``unet_variables_from_state_dict``,
gives numpy arrays in the JAX variable tree, so that a model trained here
can be held against the JAX package (the JAX package's own
``utils/torch_compat.import_torch_state`` does the same into an existing
tree). A U-Net built with ``remat_stages=True`` names its blocks
``CheckpointUNetBlock_N``; both spellings are read.

Layouts: conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw);
ConvTranspose kernel (k, k, in, out) -> weight (in, out, k, k) (the JAX
package stores it like torch, flipped at use); BatchNorm scale, bias,
mean, var -> weight, bias, running_mean, running_var.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..models.relaynet import BLOCK_NAMES as RELAYNET_BLOCKS
from ..models.unet import BLOCK_PREFIXES, UPCONV_NAMES


def _t(a, perm=None) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if perm is not None:
        a = a.transpose(perm)
    return torch.tensor(a)  # a copy: JAX hands out read-only buffers


def unet_state_dict_from_jax(variables) -> OrderedDict:
    """JAX ``UNet`` variables {"params", "batch_stats"} -> ordered state
    dict for ``models/unet.UNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = OrderedDict()

    def block(i):
        prefix = BLOCK_PREFIXES[i]
        name = f"UNetBlock_{i}"
        if name not in params:
            name = "Checkpoint" + name
        p, st = params[name], stats[name]
        for j in (0, 1):
            sd[f"{prefix}conv{j + 1}.weight"] = _t(
                p[f"Conv_{j}"]["Conv_0"]["kernel"], (3, 2, 0, 1)
            )
            bn_p = p[f"BatchNorm_{j}"]["BatchNorm_0"]
            bn_s = st[f"BatchNorm_{j}"]["BatchNorm_0"]
            norm = f"{prefix}norm{j + 1}"
            sd[f"{norm}.weight"] = _t(bn_p["scale"])
            sd[f"{norm}.bias"] = _t(bn_p["bias"])
            sd[f"{norm}.running_mean"] = _t(bn_s["mean"])
            sd[f"{norm}.running_var"] = _t(bn_s["var"])
            sd[f"{norm}.num_batches_tracked"] = torch.tensor(0)

    for i in range(5):
        block(i)
    for k, name in enumerate(UPCONV_NAMES):
        ct = params[f"ConvTranspose_{k}"]
        sd[f"{name}.weight"] = _t(ct["kernel"], (2, 3, 0, 1))
        sd[f"{name}.bias"] = _t(ct["bias"])
        block(5 + k)
    head = params["Conv_0"]["Conv_0"]
    sd["conv.weight"] = _t(head["kernel"], (3, 2, 0, 1))
    sd["conv.bias"] = _t(head["bias"])
    return sd


def unet_variables_from_state_dict(state_dict, *,
                                  remat_stages: bool = False) -> dict:
    """Port U-Net state dict -> JAX ``UNet`` variables {"params",
    "batch_stats"} as float32 numpy arrays (the inverse of
    ``unet_state_dict_from_jax``); ``remat_stages`` names the blocks
    ``CheckpointUNetBlock_N``."""
    def a(name, perm=None):
        v = state_dict[name].detach().cpu().float().numpy()
        return v.transpose(perm) if perm is not None else v

    params, stats = {}, {}

    def block(i):
        prefix = BLOCK_PREFIXES[i]
        name = ("CheckpointUNetBlock_" if remat_stages else "UNetBlock_") + \
            str(i)
        p, st = params.setdefault(name, {}), stats.setdefault(name, {})
        for j in (0, 1):
            p[f"Conv_{j}"] = {"Conv_0": {
                "kernel": a(f"{prefix}conv{j + 1}.weight", (2, 3, 1, 0))}}
            norm = f"{prefix}norm{j + 1}"
            p[f"BatchNorm_{j}"] = {"BatchNorm_0": {
                "scale": a(f"{norm}.weight"), "bias": a(f"{norm}.bias")}}
            st[f"BatchNorm_{j}"] = {"BatchNorm_0": {
                "mean": a(f"{norm}.running_mean"),
                "var": a(f"{norm}.running_var")}}

    for i in range(5):
        block(i)
    for k, name in enumerate(UPCONV_NAMES):
        params[f"ConvTranspose_{k}"] = {
            "kernel": a(f"{name}.weight", (2, 3, 0, 1)),
            "bias": a(f"{name}.bias")}
        block(5 + k)
    params["Conv_0"] = {"Conv_0": {"kernel": a("conv.weight", (2, 3, 1, 0)),
                                   "bias": a("conv.bias")}}
    return {"params": params, "batch_stats": stats}


def unet_qparams_from_jax(qparams) -> dict:
    """JAX int8 qparams (``quantize_unet`` / ``quantize_unet_psrp`` /
    ``quantize_unet_packed``: w_q, s_w, b and ``_act_scales``) -> this
    package's layout, on the CPU.
    Packed TPU weights are dropped; ``inference/psrp.attach_kernel_params``
    packs for the CUDA kernels."""
    out = {"_act_scales": {
        k: torch.tensor(np.float32(v)) for k, v in qparams["_act_scales"].items()
    }}
    for name, lw in qparams.items():
        if name.startswith("_"):
            continue
        perm = (2, 3, 0, 1) if name.startswith("ct") else (3, 2, 0, 1)
        w_q = np.asarray(lw["w_q"]).transpose(perm)
        out[name] = {
            "w_q": torch.tensor(w_q.astype(np.int8)),
            "s_w": _t(lw["s_w"]),
            "b": _t(lw["b"]),
        }
    return out


# JAX row-packed qparams (``quantize_unet_packed``) carry their own
# quantization in w_q, s_w, b and ``_act_scales``; their TPU packs
# (``w_packed_by``, ``w_stem``, ``w_head``, ``w_packed``) are dropped as the
# PSRP packs are, and ``inference/packed.attach_packed_params`` packs for the
# CUDA kernels.
unet_packed_qparams_from_jax = unet_qparams_from_jax


def relaynet_state_dict_from_jax(variables) -> OrderedDict:
    """JAX ``ReLayNet`` variables {"params", "batch_stats"} -> ordered state
    dict for ``models/relaynet.ReLayNet``."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = OrderedDict()
    for i, name in enumerate(RELAYNET_BLOCKS):
        p, st = params[f"ReLayNetBlock_{i}"], stats[f"ReLayNetBlock_{i}"]
        conv = p["Conv_0"]["Conv_0"]
        sd[f"{name}.conv.weight"] = _t(conv["kernel"], (3, 2, 0, 1))
        sd[f"{name}.conv.bias"] = _t(conv["bias"])
        bn_p, bn_s = p["BatchNorm_0"]["BatchNorm_0"], st["BatchNorm_0"][
            "BatchNorm_0"]
        sd[f"{name}.norm.weight"] = _t(bn_p["scale"])
        sd[f"{name}.norm.bias"] = _t(bn_p["bias"])
        sd[f"{name}.norm.running_mean"] = _t(bn_s["mean"])
        sd[f"{name}.norm.running_var"] = _t(bn_s["var"])
        sd[f"{name}.norm.num_batches_tracked"] = torch.tensor(0)
        sd[f"{name}.prelu.weight"] = _t(p["PReLU_0"]["alpha"])
    head = params["Conv_0"]["Conv_0"]
    sd["classifier.weight"] = _t(head["kernel"], (3, 2, 0, 1))
    sd["classifier.bias"] = _t(head["bias"])
    return sd


def relaynet_variables_from_state_dict(state_dict) -> dict:
    """Port ReLayNet state dict -> JAX ``ReLayNet`` variables {"params",
    "batch_stats"} as float32 numpy arrays (the inverse of
    ``relaynet_state_dict_from_jax``)."""
    def a(name, perm=None):
        v = state_dict[name].detach().cpu().float().numpy()
        return v.transpose(perm) if perm is not None else v

    params, stats = {}, {}
    for i, name in enumerate(RELAYNET_BLOCKS):
        params[f"ReLayNetBlock_{i}"] = {
            "Conv_0": {"Conv_0": {
                "kernel": a(f"{name}.conv.weight", (2, 3, 1, 0)),
                "bias": a(f"{name}.conv.bias")}},
            "BatchNorm_0": {"BatchNorm_0": {
                "scale": a(f"{name}.norm.weight"),
                "bias": a(f"{name}.norm.bias")}},
            "PReLU_0": {"alpha": a(f"{name}.prelu.weight")},
        }
        stats[f"ReLayNetBlock_{i}"] = {"BatchNorm_0": {"BatchNorm_0": {
            "mean": a(f"{name}.norm.running_mean"),
            "var": a(f"{name}.norm.running_var")}}}
    params["Conv_0"] = {"Conv_0": {
        "kernel": a("classifier.weight", (2, 3, 1, 0)),
        "bias": a("classifier.bias")}}
    return {"params": params, "batch_stats": stats}


def relaynet_qparams_from_jax(qparams) -> dict:
    """JAX ReLayNet int8 qparams (``quantize_relaynet`` /
    ``quantize_relaynet_psrp``: w_q, s_w, b, alpha and ``_act_scales``) ->
    this package's layout, on the CPU. Packed TPU weights are dropped;
    ``inference/relaynet_psrp.attach_kernel_params`` packs for K7 and K3."""
    out = {"_act_scales": {
        k: torch.tensor(np.float32(v)) for k, v in qparams["_act_scales"].items()
    }}
    for name, lw in qparams.items():
        if name.startswith("_"):
            continue
        w_q = np.asarray(lw["w_q"]).transpose(3, 2, 0, 1)
        out[name] = {"w_q": torch.tensor(w_q.astype(np.int8)),
                     "s_w": _t(lw["s_w"]), "b": _t(lw["b"])}
        if "alpha" in lw:
            out[name]["alpha"] = _t(lw["alpha"]).reshape(())
    return out
