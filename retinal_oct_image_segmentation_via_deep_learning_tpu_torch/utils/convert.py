"""JAX U-Net, ReLayNet and SDNet weights <-> this package's state dicts (and
JAX int8 qparams -> this package's qparams).

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


# prefixes of the w4a4 mode's keys in U-Net qparams (``_deep_int4``,
# ``_deep_w4``, ``_deep_a4``, ``_w8_<stage>``), whose presence is the mode
MODE_KEY_PREFIXES = ("_deep_", "_w8_")


def unet_qparams_from_jax(qparams) -> dict:
    """JAX U-Net qparams (``quantize_unet`` / ``quantize_unet_psrp`` in any
    ``deep_int4`` mode / ``quantize_unet_packed``: w_q, s_w, b, ``wsum4``,
    ``_act_scales`` and the mode keys ``_deep_*`` and ``_w8_*``) -> this
    package's layout, on the CPU.
    Packed TPU weights are dropped; ``inference/psrp.attach_kernel_params``
    packs for the CUDA kernels."""
    out = {"_act_scales": {
        k: torch.tensor(np.float32(v)) for k, v in qparams["_act_scales"].items()
    }}
    for name, lw in qparams.items():
        if name.startswith(MODE_KEY_PREFIXES):
            out[name] = True
        if name.startswith("_"):
            continue
        perm = (2, 3, 0, 1) if name.startswith("ct") else (3, 2, 0, 1)
        w_q = np.asarray(lw["w_q"]).transpose(perm)
        out[name] = {
            "w_q": torch.tensor(w_q.astype(np.int8)),
            "s_w": _t(lw["s_w"]),
            "b": _t(lw["b"]),
        }
        if "wsum4" in lw:  # (cout,), or (2, 2, cout) for ct0/ct1
            out[name]["wsum4"] = _t(lw["wsum4"])
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


def _res_block_map(tp: str, fp: tuple) -> list:
    return [(f"{tp}.init_conv", fp + ("Conv_0",), "conv"),
            (f"{tp}.conv1", fp + ("Conv_1",), "conv"),
            (f"{tp}.conv2", fp + ("Conv_2",), "conv"),
            (f"{tp}.bn1", fp + ("BatchNorm_0",), "bn"),
            (f"{tp}.bn2", fp + ("BatchNorm_1",), "bn")]


# an AttentionGate's (conv, BN) pairs, in the Flax call order
_GATE_LAYERS = (("w_g", "bn_g"), ("w_x", "bn_x"), ("psi", "bn_psi"))


def backbone_layer_map(levels: int, attention: bool, prefix: str = "",
                       path: tuple = ()) -> list:
    """[(port module name, Flax module path, "conv" | "bn" | "dense")] of a
    ``models/sdnet/unet.UNetBackbone`` with ``levels`` levels, its names
    under ``prefix`` and its Flax modules under ``path``. A Flax ``Conv``
    or ``BatchNorm`` wrapper holds its layer as ``Conv_0`` /
    ``BatchNorm_0``; a ``Dense`` holds its own kernel."""
    out = []
    for i in range(levels):
        out += _res_block_map(f"{prefix}enc.{i}",
                              path + (f"ResConvBlock_{i}",))
    for k in range(levels - 1):
        up = path + (f"UpConv_{k}",)
        out += [(f"{prefix}up.{k}.conv", up + ("Conv_0",), "conv"),
                (f"{prefix}up.{k}.bn", up + ("BatchNorm_0",), "bn")]
        gate = path + (f"AttentionGate_{k}",)
        for j, (conv, bn) in enumerate(_GATE_LAYERS if attention else ()):
            out += [(f"{prefix}att.{k}.{conv}", gate + (f"Conv_{j}",), "conv"),
                    (f"{prefix}att.{k}.{bn}", gate + (f"BatchNorm_{j}",), "bn")]
        out += _res_block_map(f"{prefix}dec.{k}",
                              path + (f"ResConvBlock_{levels + k}",))
    out.append((f"{prefix}head", path + ("Conv_0",), "conv"))
    return out


def sdnet_layer_map(levels: int, surface: bool) -> list:
    """``backbone_layer_map`` for the whole SDNet (``levels`` U-Net
    levels, with or without the surface predictor)."""
    out = backbone_layer_map(levels, True, "u_net.", ("u_net",))
    for name in ("layer_predictor",) + (("surface_predictor",) if surface
                                        else ()):
        out += _res_block_map(f"{name}.block", (name, "ResConvBlock_0"))
        out.append((f"{name}.head", (name, "Conv_0"), "conv"))
    m = ("modality_encoder",)
    for i in range(4):
        out += [(f"modality_encoder.convs.{i}", m + (f"Conv_{i}",), "conv"),
                (f"modality_encoder.bns.{i}", m + (f"BatchNorm_{i}",), "bn")]
    out += [("modality_encoder.fc", m + ("Dense_0",), "dense"),
            ("modality_encoder.fc_bn", m + ("BatchNorm_4",), "bn"),
            ("modality_encoder.z_mean", m + ("Dense_1",), "dense"),
            ("modality_encoder.z_logvar", m + ("Dense_2",), "dense")]
    for i in range(4):
        f = ("decoder", f"FiLMLayer_{i}")
        out += [(f"decoder.film.{i}.conv1", f + ("Conv_0",), "conv"),
                (f"decoder.film.{i}.conv2", f + ("Conv_1",), "conv"),
                (f"decoder.film.{i}.fc1", f + ("Dense_0",), "dense"),
                (f"decoder.film.{i}.fc2", f + ("Dense_1",), "dense")]
    out.append(("decoder.out", ("decoder", "Conv_0"), "conv"))
    return out


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def state_dict_from_jax(variables, layer_map) -> OrderedDict:
    """JAX variables {"params", "batch_stats"} -> the state dict of the
    port module that ``layer_map`` describes. Conv kernels (kh, kw, in,
    out) -> (out, in, kh, kw); Dense kernels (in, out) -> (out, in)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = OrderedDict()
    for name, path, kind in layer_map:
        if kind == "bn":
            p = _node(params, path)["BatchNorm_0"]
            s = _node(stats, path)["BatchNorm_0"]
            sd[f"{name}.weight"] = _t(p["scale"])
            sd[f"{name}.bias"] = _t(p["bias"])
            sd[f"{name}.running_mean"] = _t(s["mean"])
            sd[f"{name}.running_var"] = _t(s["var"])
            sd[f"{name}.num_batches_tracked"] = torch.tensor(0)
            continue
        p = _node(params, path)
        if kind == "conv":
            p = p["Conv_0"]
        sd[f"{name}.weight"] = _t(p["kernel"],
                                  (3, 2, 0, 1) if kind == "conv" else (1, 0))
        sd[f"{name}.bias"] = _t(p["bias"])
    return sd


def variables_from_state_dict(state_dict, layer_map) -> dict:
    """The inverse of ``state_dict_from_jax``: JAX variables {"params",
    "batch_stats"} as float32 numpy arrays."""
    def a(name, perm=None):
        v = state_dict[name].detach().cpu().float().numpy()
        return v.transpose(perm) if perm is not None else v

    def put(tree, path, leaf):
        for k in path[:-1]:
            tree = tree.setdefault(k, {})
        tree[path[-1]] = leaf

    params, stats = {}, {}
    for name, path, kind in layer_map:
        if kind == "bn":
            put(params, path + ("BatchNorm_0",), {
                "scale": a(f"{name}.weight"), "bias": a(f"{name}.bias")})
            put(stats, path + ("BatchNorm_0",), {
                "mean": a(f"{name}.running_mean"),
                "var": a(f"{name}.running_var")})
        else:
            leaf = {"kernel": a(f"{name}.weight",
                                (2, 3, 1, 0) if kind == "conv" else (1, 0)),
                    "bias": a(f"{name}.bias")}
            put(params, path + (("Conv_0",) if kind == "conv" else ()), leaf)
    return {"params": params, "batch_stats": stats}


def sdnet_state_dict_from_jax(variables) -> OrderedDict:
    """JAX ``SDNet`` variables {"params", "batch_stats"} -> state dict for
    ``models/sdnet.SDNet``."""
    params = variables["params"]
    blocks = sum(k.startswith("ResConvBlock_") for k in params["u_net"])
    return state_dict_from_jax(variables, sdnet_layer_map(
        (blocks + 1) // 2, "surface_predictor" in params))


def sdnet_variables_from_state_dict(state_dict) -> dict:
    """Port SDNet state dict -> JAX ``SDNet`` variables (the inverse of
    ``sdnet_state_dict_from_jax``)."""
    levels = sum(k.startswith("u_net.enc.") and k.endswith(".conv1.weight")
                 for k in state_dict)
    return variables_from_state_dict(state_dict, sdnet_layer_map(
        levels, "surface_predictor.head.weight" in state_dict))
