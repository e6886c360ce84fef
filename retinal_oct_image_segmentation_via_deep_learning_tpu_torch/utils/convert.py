"""JAX model weights <-> this package's state dicts (and JAX int8 qparams
-> this package's qparams).

Inputs are numpy arrays (or anything ``np.asarray`` takes); nothing of JAX
is imported. One design carries every model: a layer map, [(port module
name, Flax module path, kind)], read by ``state_dict_from_jax`` and
``variables_from_state_dict`` (the reverse gives numpy arrays in the JAX
variable tree, so that a model trained here can be held against the JAX
package). The U-Net's and ReLayNet's maps are fixed (``unet_layer_map``,
whose ``remat_stages`` spelling names the blocks ``CheckpointUNetBlock_N``;
``relaynet_layer_map``), SDNet's follows its levels, and ``layer_map`` reads
the map of Y-Net, EdgeAL, AnoGAN, FourierNet, MGU-Net, ISLAM, LightReSeg,
MSNet/M2SNet (and LossNet), BioNet, WAT-Net, RetiFluidNet, Masood, their
backbones and attention units, or an FFC unit off the built port module.
``unet_state_dict_from_jax`` and the other named pairs wrap the two
directions.

Layouts: conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw);
ConvTranspose kernel (k, k, in, out) -> weight (in, out, k, k) (the JAX
package stores it like torch, flipped at use); Dense (in, out) -> (out,
in); BatchNorm scale, bias, mean, var -> weight, bias, running_mean,
running_var; GroupNorm and LayerNorm scale, bias -> weight, bias; PReLU
alpha -> weight; a bare parameter (``cls_token``, ``gamma``) as it is.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..models import blocks, ffc
from ..models.anogan import AnoGAN
from ..models.bionet import BioNet
from ..models.edgeal import EdgeAL
from ..models.fouriernet import FourierNet
from ..models.islam import ISLAM
from ..models.lightreseg import LightReSeg
from ..models.masood import Masood2024
from ..models.mgunet import MGUNet
from ..models.msnet import LossNet, MSNet
from ..models.res2net import Bottle2neck, Res2Net50Features
from ..models.resnet import BasicBlock, ResNetFeatures
from ..models.retifluidnet import SDA, RetiFluidNet
from ..models.sdnet.unet import UNetBackbone
from ..models.watnet import WAT, WATNet
from ..models.relaynet import BLOCK_NAMES as RELAYNET_BLOCKS
from ..models.unet import BLOCK_PREFIXES, UPCONV_NAMES, YNet


def _t(a, perm=None) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    if perm is not None:
        a = a.transpose(perm)
    return torch.tensor(a)  # a copy: JAX hands out read-only buffers


def _unet_block(prefix: str, path: tuple) -> list:
    """A ``unet_block`` named ``prefix`` (conv, BN, ReLU twice), held in
    Flax as a ``UNetBlock`` at ``path``."""
    return [(f"{prefix}{name}{j + 1}", path + (f"{layer}_{j}",), kind)
            for j in (0, 1)
            for name, layer, kind in (("conv", "Conv", "conv"),
                                      ("norm", "BatchNorm", "bn"))]


def unet_layer_map(remat_stages: bool = False) -> list:
    """The U-Net's layer map; a JAX U-Net built with ``remat_stages=True``
    names its blocks ``CheckpointUNetBlock_N``."""
    stem = "CheckpointUNetBlock_" if remat_stages else "UNetBlock_"
    out = [e for i in range(5)
           for e in _unet_block(BLOCK_PREFIXES[i], (f"{stem}{i}",))]
    for k, name in enumerate(UPCONV_NAMES):
        out += [(name, (f"ConvTranspose_{k}",), "ct")] + _unet_block(
            BLOCK_PREFIXES[5 + k], (f"{stem}{5 + k}",))
    return out + [("conv", ("Conv_0",), "conv")]


def unet_state_dict_from_jax(variables) -> OrderedDict:
    """JAX ``UNet`` variables {"params", "batch_stats"} -> state dict for
    ``models/unet.UNet`` (either block spelling)."""
    remat = "CheckpointUNetBlock_0" in variables["params"]
    return state_dict_from_jax(variables, unet_layer_map(remat))


def unet_variables_from_state_dict(state_dict, *,
                                  remat_stages: bool = False) -> dict:
    """Port U-Net state dict -> JAX ``UNet`` variables (the inverse of
    ``unet_state_dict_from_jax``)."""
    return variables_from_state_dict(state_dict, unet_layer_map(remat_stages))


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


def relaynet_layer_map() -> list:
    out = []
    for i, name in enumerate(RELAYNET_BLOCKS):
        path = (f"ReLayNetBlock_{i}",)
        out += [(f"{name}.conv", path + ("Conv_0",), "conv"),
                (f"{name}.norm", path + ("BatchNorm_0",), "bn"),
                (f"{name}.prelu", path + ("PReLU_0",), "prelu")]
    return out + [("classifier", ("Conv_0",), "conv")]


def relaynet_state_dict_from_jax(variables) -> OrderedDict:
    """JAX ``ReLayNet`` variables -> state dict for
    ``models/relaynet.ReLayNet``."""
    return state_dict_from_jax(variables, relaynet_layer_map())


def relaynet_variables_from_state_dict(state_dict) -> dict:
    """Port ReLayNet state dict -> JAX ``ReLayNet`` variables (the inverse
    of ``relaynet_state_dict_from_jax``)."""
    return variables_from_state_dict(state_dict, relaynet_layer_map())


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


# -- the FFC stack and the zoo models: maps read off the port modules --------


def _fourier_unit_map(m, prefix, path) -> list:
    return [(f"{prefix}conv", path + ("Conv_0",), "conv"),
            (f"{prefix}bn", path + ("BatchNorm_0",), "bn")]


def _spectral_map(m, prefix, path) -> list:
    out = [(f"{prefix}conv1", path + ("Conv_0",), "conv"),
           (f"{prefix}bn", path + ("BatchNorm_0",), "bn")]
    out += _fourier_unit_map(m.fu, f"{prefix}fu.", path + ("FourierUnit_0",))
    if m.lfu is not None:
        out += _fourier_unit_map(m.lfu, f"{prefix}lfu.",
                                 path + ("FourierUnit_1",))
    return out + [(f"{prefix}conv2", path + ("Conv_1",), "conv")]


def _ffc_map(m, prefix, path) -> list:
    names = [n for n in ("l2l", "l2g", "g2l") if getattr(m, n) is not None]
    out = [(f"{prefix}{n}", path + (f"Conv_{j}",), "conv")
           for j, n in enumerate(names)]
    if m.g2g is not None:
        out += _spectral_map(m.g2g, f"{prefix}g2g.",
                             path + ("SpectralTransform_0",))
    return out


def _ffc_bn_act_map(m, prefix, path) -> list:
    out = _ffc_map(m.ffc, f"{prefix}ffc.", path + ("FFC_0",))
    bns = [n for n in ("bn_l", "bn_g") if getattr(m, n) is not None]
    return out + [(f"{prefix}{n}", path + (f"BatchNorm_{j}",), "bn")
                  for j, n in enumerate(bns)]


def _resnet_block_map(m, prefix, path) -> list:
    return (_ffc_bn_act_map(m.conv1, f"{prefix}conv1.",
                            path + ("FFC_BN_ACT_0",))
            + _ffc_bn_act_map(m.conv2, f"{prefix}conv2.",
                              path + ("FFC_BN_ACT_1",)))


def _se_block_map(m, prefix, path) -> list:
    names = ["conv1"] + [n for n in ("conv_a2l", "conv_a2g")
                         if getattr(m, n) is not None]
    return [(f"{prefix}{n}", path + (f"Conv_{j}",), "conv")
            for j, n in enumerate(names)]


def _spatial_wrapper_map(m, prefix, path) -> list:
    return [(prefix.rstrip("."), path, "angle")] + layer_map(
        m.impl, f"{prefix}impl.", path + ("impl",))


def _ynet_map(m, prefix, path) -> list:
    names = [f"encoder{i}" for i in (1, 2, 3, 4)]
    if not m.ffc:
        names += [f"encoder{i}_f" for i in (1, 2, 3, 4)]
    names += ["bottleneck"] + [f"decoder{i}" for i in (4, 3, 2, 1)]

    def block(name):  # unet_block "encoder1" is named "enc1", and so on
        short = name.replace("encoder", "enc").replace("decoder", "dec")
        return _unet_block(f"{prefix}{name}.{short}",
                           path + (f"UNetBlock_{names.index(name)}",))

    out = [e for i in (1, 2, 3, 4) for e in block(f"encoder{i}")]
    for i in (1, 2, 3, 4):
        name = f"encoder{i}_f"
        out += (_ffc_bn_act_map(getattr(m, name), f"{prefix}{name}.",
                                path + (f"FFC_BN_ACT_{i - 1}",))
                if m.ffc else block(name))
    out += block("bottleneck")
    for k, i in enumerate((4, 3, 2, 1)):
        out.append((f"{prefix}upconv{i}", path + (f"ConvTranspose_{k}",),
                    "ct"))
        out += block(f"decoder{i}")
    return out + [(f"{prefix}conv", path + ("Conv_0",), "conv")]


def _edgeal_map(m, prefix, path) -> list:
    out = _ffc_bn_act_map(m.stem, f"{prefix}stem.", path + ("FFC_BN_ACT_0",))
    for i, d in enumerate(m.downs):
        out += _ffc_bn_act_map(d, f"{prefix}downs.{i}.",
                               path + (f"FFC_BN_ACT_{i + 1}",))
    for i, b in enumerate(m.blocks):
        out += _resnet_block_map(b, f"{prefix}blocks.{i}.",
                                 path + (f"FFCResnetBlock_{i}",))
    for i in range(len(m.ups)):
        out += [(f"{prefix}ups.{i}", path + (f"ConvTranspose_{i}",), "ct"),
                (f"{prefix}up_bns.{i}", path + (f"BatchNorm_{i}",), "bn")]
    return out + [(f"{prefix}head", path + ("Conv_0",), "conv")]


def _indexed(prefix, path, name, layer, kind, n) -> list:
    return [(f"{prefix}{name}.{i}", path + (f"{layer}_{i}",), kind)
            for i in range(n)]


def _anogan_map(m, prefix, path) -> list:
    def encoder(p, fp):
        return (_indexed(p, fp, "convs", "Conv", "conv", 4)
                + _indexed(p, fp, "bns", "BatchNorm", "bn", 2))

    return (encoder(f"{prefix}G.encoder.", path + ("G", "encoder"))
            + _indexed(f"{prefix}G.decoder.", path + ("G", "decoder"),
                       "ups", "ConvTranspose", "ct", 4)
            + _indexed(f"{prefix}G.decoder.", path + ("G", "decoder"),
                       "bns", "BatchNorm", "bn", 3)
            + encoder(f"{prefix}D.encoder.", path + ("D", "Encoder_0"))
            + [(f"{prefix}D.fc1", path + ("D", "Conv_0"), "conv"),
               (f"{prefix}D.fc2", path + ("D", "Conv_1"), "conv")])


def _fouriernet_map(m, prefix, path) -> list:
    def block(p, fp):
        return [(f"{p}conv1", fp + ("Conv_0",), "conv"),
                (f"{p}conv2", fp + ("Conv_1",), "conv")]

    def blocks(p, fp):
        return [e for i in range(4)
                for e in block(f"{p}blocks.{i}.", fp + (f"UNetBlock2_{i}",))]

    def unet(p, fp, decoders, heads):
        out = blocks(f"{p}encoder.", fp + ("_Encoder_0",))
        out += block(f"{p}bottleneck.", fp + ("UNetBlock2_0",))
        for k, (dec, head) in enumerate(zip(decoders, heads)):
            out += blocks(f"{p}{dec}.", fp + (f"_Decoder_{k}",))
            out.append((f"{p}{head}", fp + (f"Conv_{k}",), "conv"))
        return out

    k = len(m.decoders)
    return (unet(prefix, path, [f"decoders.{i}" for i in range(k)],
                 [f"fd_heads.{i}" for i in range(k)])
            + unet(f"{prefix}cas.", path + ("CasUNet_0",), ["decoder"],
                   ["head"]))


def _basconv_map(prefix, path) -> list:
    """An MGU-Net ``Basconv``: its BatchNorm is a bare flax one."""
    return [(f"{prefix}conv", path + ("Conv_0",), "conv"),
            (f"{prefix}bn", path + ("BatchNorm_0",), "bare_bn")]


def _unet_conv_map(prefix, path) -> list:
    return [(f"{prefix}conv{j + 1}.{name}", path + (f"{layer}_{j}",), kind)
            for j in (0, 1)
            for name, layer, kind in (("conv", "Conv", "conv"),
                                      ("bn", "BatchNorm", "bare_bn"))]


def _glore_map(prefix, path) -> list:
    return [(f"{prefix}{name}", path + (f"Conv_{j}",), "conv")
            for j, name in enumerate(("state", "proj", "extend"))]


def _mgunet_map(m, prefix, path) -> list:
    out = []
    for i in range(3):
        out += _unet_conv_map(f"{prefix}encoders.{i}.", path + (
            f"UnetConv_{i}",))
    mgr, mp = f"{prefix}mgr.", path + ("MGRModule_0",)
    out += _basconv_map(f"{mgr}branch0.", mp + ("Basconv_0",))
    out += _glore_map(f"{mgr}glore0.", mp + ("GloReUnit_0",))
    for i in range(3):  # flax numbers the branches' Basconvs in call order
        out += _basconv_map(f"{mgr}pre.{i}.", mp + (f"Basconv_{2 * i + 1}",))
        out += _basconv_map(f"{mgr}post.{i}.", mp + (f"Basconv_{2 * i + 2}",))
        out += _glore_map(f"{mgr}glore.{i}.", mp + (f"GloReUnit_{i + 1}",))
    out += _basconv_map(f"{mgr}fuse.", mp + ("Basconv_7",))
    out += _unet_conv_map(f"{prefix}center.", path + ("UnetConv_3",))
    for k in range(3):
        out.append((f"{prefix}ups.{k}", path + (
            (f"ConvTranspose_{k}",) if m.is_deconv else (f"Conv_{k}",)),
            "ct" if m.is_deconv else "conv"))
        out += _unet_conv_map(f"{prefix}decoders.{k}.",
                              path + (f"UnetConv_{k + 4}",))
    head = "Conv_0" if m.is_deconv else "Conv_3"
    return out + [(f"{prefix}head", path + (head,), "conv")]


def _se_map(prefix, path) -> list:
    return [(f"{prefix}fc{j + 1}", path + (f"Dense_{j}",), "dense")
            for j in (0, 1)]


def _islam_res_map(prefix, path, stem=False) -> list:
    """A ``StemBlock`` or ``ResNetBlock``, in its flax call order."""
    if stem:
        names = (("conv1", "Conv_0", "conv"), ("bn1", "BatchNorm_0", "bn"),
                 ("conv2", "Conv_1", "conv"), ("short", "Conv_2", "conv"),
                 ("bn_short", "BatchNorm_1", "bn"))
    else:
        names = (("bn1", "BatchNorm_0", "bn"), ("conv1", "Conv_0", "conv"),
                 ("bn2", "BatchNorm_1", "bn"), ("conv2", "Conv_1", "conv"),
                 ("short", "Conv_2", "conv"),
                 ("bn_short", "BatchNorm_2", "bn"))
    return ([(f"{prefix}{n}", path + (layer,), kind)
             for n, layer, kind in names]
            + _se_map(f"{prefix}se.", path + ("SqueezeExcitation_0",)))


def _aspp_map(m, prefix, path) -> list:
    gn = isinstance(m.norms[0], torch.nn.GroupNorm)
    out = []
    for i in range(len(m.convs)):
        out += [(f"{prefix}convs.{i}", path + (f"Conv_{i}",), "conv"),
                (f"{prefix}norms.{i}", path + (
                    (f"GroupNorm_{i}",) if gn else (f"BatchNorm_{i}",)),
                 "norm" if gn else "bn")]
    return out + [(f"{prefix}out", path + (f"Conv_{len(m.convs)}",), "conv")]


def _islam_decoder_map(prefix, path) -> list:
    a, ap = f"{prefix}att.", path + ("AttentionBlock_0",)
    out = [(f"{a}{n}", ap + (f"{layer}_{j}",), kind)
           for j, (bn, cv) in enumerate((("bn_g", "conv_g"),
                                         ("bn_x", "conv_x"),
                                         ("bn_gc", "conv_gc")))
           for n, layer, kind in ((bn, "BatchNorm", "bn"),
                                  (cv, "Conv", "conv"))]
    return out + _islam_res_map(f"{prefix}res.", path + ("ResNetBlock_0",))


def _islam_map(m, prefix, path) -> list:
    out = _islam_res_map(f"{prefix}stem.", path + ("StemBlock_0",), True)
    for i in range(5):
        out += _islam_res_map(f"{prefix}stages.{i}.",
                              path + (f"ResNetBlock_{i}",))
    out += _aspp_map(m.aspp, f"{prefix}aspp.", path + ("ASPP_0",))
    for i in range(3):
        out += _islam_decoder_map(f"{prefix}decoders.{i}.",
                                  path + (f"DecoderBlock_{i}",))
    out += _islam_decoder_map(f"{prefix}dec5.", path + ("DecoderBlock_3",))
    if m.use_multi_head:
        heads = [f"heads.{i}" for i in range(3)]
        if m.gaussian_output:
            heads += [f"var_heads.{i}" for i in range(3)]
        for i, h in enumerate(heads):
            hp = path + (f"CustomHead_{i}",)
            out += _islam_decoder_map(f"{prefix}{h}.dec.",
                                      hp + ("DecoderBlock_0",))
            out += _aspp_map(m.heads[0].aspp, f"{prefix}{h}.aspp.",
                             hp + ("ASPP_0",))
            out.append((f"{prefix}{h}.out", hp + ("Conv_0",), "conv"))
        return out
    out += _islam_decoder_map(f"{prefix}dec6.", path + ("DecoderBlock_4",))
    out += _aspp_map(m.aspp_out, f"{prefix}aspp_out.", path + ("ASPP_1",))
    out.append((f"{prefix}conv9", path + ("Conv_0",), "conv"))
    if m.gn is not None:
        out.append((f"{prefix}gn", path + ("GroupNorm_0",), "norm"))
    return out + [(f"{prefix}head", path + ("Conv_1",), "conv")]


def _contracting_map(prefix, path) -> list:
    return [(f"{prefix}{n}{j + 1}", path + (f"{layer}_{j}",), kind)
            for j in (0, 1)
            for n, layer, kind in (("conv", "Conv", "conv"),
                                   ("bn", "BatchNorm", "bn"))]


def _separable_map(prefix, path) -> list:
    out = [(f"{prefix}{n}", path + (f"Conv_{j}",), "conv")
           for j, n in enumerate(("dw1", "pw1", "dw2", "pw2"))]
    return out + [(f"{prefix}bn{j + 1}", path + (f"BatchNorm_{j}",), "bn")
                  for j in (0, 1)]


def _lightreseg_map(m, prefix, path) -> list:
    out = []
    for i in range(4):
        out += _contracting_map(f"{prefix}contract.{i}.",
                                path + (f"ContractingBlock_{i}",))
        out += _separable_map(f"{prefix}down.{i}.",
                              path + (f"SeparableDown_{i}",))
    out += [(f"{prefix}embed", path + ("Dense_0",), "dense"),
            (f"{prefix}cls_token", path + ("cls_token",), "param"),
            (f"{prefix}pos_embedding", path + ("pos_embedding",), "param")]
    vp = path + ("ViTBlockStack_0",)
    for i in range(len(m.vit)):  # flax numbers each kind across the layers
        v = f"{prefix}vit.{i}."
        out += [(f"{v}norm1", vp + (f"LayerNorm_{2 * i}",), "norm"),
                (f"{v}attn.qkv", vp + (f"ViTAttention_{i}", "Dense_0"),
                 "dense"),
                (f"{v}attn.out", vp + (f"ViTAttention_{i}", "Dense_1"),
                 "dense"),
                (f"{v}norm2", vp + (f"LayerNorm_{2 * i + 1}",), "norm"),
                (f"{v}fc1", vp + (f"Dense_{2 * i}",), "dense"),
                (f"{v}fc2", vp + (f"Dense_{2 * i + 1}",), "dense")]
    out += _contracting_map(f"{prefix}bottleneck.",
                            path + ("ContractingBlock_4",))
    for i in range(4):
        e, ep = f"{prefix}expand.{i}.", path + (f"ExpansiveBlock_{i}",)
        ap = ep + ("AttentionModule_0",)
        out.append((f"{e}up", ep + ("ConvTranspose_0",), "ct"))
        out += [(f"{e}att.dw.{j}", ap + (f"Conv_{j}",), "conv")
                for j in range(7)]
        out += [(f"{e}att.cam.{j}.gamma",
                 ap + (f"ChannelAttentionModule_{j}", "gamma"), "param")
                for j in range(4)]
        out.append((f"{e}att.gate", ap + ("Conv_7",), "conv"))
    return out + [(f"{prefix}head", path + ("Conv_0",), "conv"),
                  (f"{prefix}head_bn", path + ("BatchNorm_0",), "bn")]


def _pairs(prefix, path, convs, bns) -> list:
    """The j-th name of ``convs`` at ``Conv_j`` and of ``bns`` at
    ``BatchNorm_j`` (a block whose Flax convs and BatchNorms are numbered
    in the same order)."""
    return ([(f"{prefix}{n}", path + (f"Conv_{j}",), "conv")
             for j, n in enumerate(convs)]
            + [(f"{prefix}{n}", path + (f"BatchNorm_{j}",), "bn")
               for j, n in enumerate(bns)])


def _conv_bn_map(prefix, path) -> list:
    """A conv-BN block (``ConvBR``, ``CNN1``)."""
    return _pairs(prefix, path, ("conv",), ("bn",))


def _double_conv_map(prefix, path) -> list:
    """(conv, BN) x 2 as ``conv1``/``bn1``, ``conv2``/``bn2`` (BioNet's
    ``ConvBlock``, WAT-Net's ``X2Conv``, RetiFluidNet's ``ConvStage``)."""
    return _pairs(prefix, path, ("conv1", "conv2"), ("bn1", "bn2"))


def _downsampled(m, names):
    return names + (("down",) if m.down is not None else ())


def _bn_names(convs):
    """The BatchNorm beside each conv of a residual block."""
    return [n.replace("conv", "bn").replace("down", "down_bn") for n in convs]


def _bottle2neck_map(m, prefix, path) -> list:
    convs = _downsampled(m, ("conv1",) + tuple(
        f"convs.{t}" for t in range(len(m.convs))) + ("conv3",))
    return _pairs(prefix, path, convs, _bn_names(convs))


def _res2net_map(m, prefix, path) -> list:
    out = _pairs(prefix, path, [f"stem.{j}" for j in range(3)],
                 [f"stem_bns.{j}" for j in range(3)])
    blocks = [b for layer in m.layers for b in layer]
    names = [f"layers.{i}.{j}" for i, layer in enumerate(m.layers)
             for j in range(len(layer))]
    for k, (b, name) in enumerate(zip(blocks, names)):
        out += _bottle2neck_map(b, f"{prefix}{name}.",
                                path + (f"Bottle2neck_{k}",))
    return out


def _msnet_map(m, prefix, path) -> list:
    out = _res2net_map(m.backbone, f"{prefix}backbone.",
                       path + ("Res2Net50Features_0",))
    if m.multi_kernel:
        out += _conv_bn_map(f"{prefix}conv_3.", path + ("CNN1_0",))
        out += _conv_bn_map(f"{prefix}conv_5.", path + ("CNN1_1",))
    for j in range(len(m.convbr)):
        out += _conv_bn_map(f"{prefix}convbr.{j}.", path + (f"ConvBR_{j}",))
    return out + [(f"{prefix}head", path + ("Conv_0",), "conv")]


def _lossnet_map(m, prefix, path) -> list:
    return [(f"{prefix}vgg.convs.{j}", path + ("VGG16Slices_0", f"Conv_{j}"),
             "conv") for j in range(len(m.vgg.convs))]


def _resnet_unit_map(m, prefix, path) -> list:
    """A ``BasicBlock`` or ``Bottleneck``."""
    convs = _downsampled(m, ("conv1", "conv2") if isinstance(m, BasicBlock)
                         else ("conv1", "conv2", "conv3"))
    return _pairs(prefix, path, convs, _bn_names(convs))


def _resnet_map(m, prefix, path) -> list:
    out = _pairs(prefix, path, ("stem",), ("stem_bn",))
    blocks = [b for layer in m.layers for b in layer]
    names = [f"layers.{i}.{j}" for i, layer in enumerate(m.layers)
             for j in range(len(layer))]
    for k, (b, name) in enumerate(zip(blocks, names)):
        kind = "BasicBlock" if isinstance(b, BasicBlock) else "Bottleneck"
        out += _resnet_unit_map(b, f"{prefix}{name}.",
                                path + (f"{kind}_{k}",))
    return out


def _bio_unet_map(m, prefix, path) -> list:
    out = []
    for j in range(4):
        out += _double_conv_map(f"{prefix}encoders.{j}.",
                                path + (f"_ConvBlock_{j}",))
    for k in range(3):
        out.append((f"{prefix}ups.{k}", path + (f"ConvTranspose_{k}",),
                    "ct"))
        out += _double_conv_map(f"{prefix}decoders.{k}.",
                                path + (f"_ConvBlock_{k + 4}",))
    return out + [(f"{prefix}head", path + ("Conv_0",), "conv")]


def _bionet_map(m, prefix, path) -> list:
    bp = path + ("BioRegularization_0",)
    return (_bio_unet_map(m.gms, f"{prefix}gms.", path + ("BioUNet_0",))
            + _bio_unet_map(m.lcs, f"{prefix}lcs.", path + ("BioUNet_1",))
            + [(f"{prefix}bio.proj", bp + ("Conv_0",), "conv")]
            + _resnet_map(m.bio.resnet, f"{prefix}bio.resnet.",
                          bp + ("ResNetFeatures_0",))
            + [(f"{prefix}bio.fc", bp + ("Dense_0",), "dense")])


def _wat_map(m, prefix, path) -> list:
    return [(f"{prefix}fc{j + 1}", path + (f"Dense_{j}",), "dense")
            for j in (0, 1)]


def _watnet_map(m, prefix, path) -> list:
    """Flax's ``setup`` names: ``start_conv``, ``convs_0``, ..."""
    out = _double_conv_map(f"{prefix}start_conv.", path + ("start_conv",))
    for name in ("convs", "dec_convs"):
        for j in range(len(getattr(m, name))):
            out += _double_conv_map(f"{prefix}{name}.{j}.",
                                    path + (f"{name}_{j}",))
    out += _double_conv_map(f"{prefix}middle_conv.", path + ("middle_conv",))
    for j in range(len(m.wats)):
        out += _wat_map(m.wats[j], f"{prefix}wats.{j}.",
                        path + (f"wats_{j}",))
    out += [(f"{prefix}uppools.{j}", path + (f"uppools_{j}",), "ct")
            for j in range(len(m.uppools))]
    return out + [(f"{prefix}final_conv", path + ("final_conv",), "conv")]


def _sda_map(m, prefix, path) -> list:
    return [(f"{prefix}pixel_conv", path + ("Conv_0",), "conv"),
            (f"{prefix}chan_conv", path + ("Conv_1",), "conv")]


def _retifluidnet_map(m, prefix, path) -> list:
    """Flax numbers the stages, SDAs and 1x1 convs in call order: the
    initial conv, the five encoder stages, the bottom head, then each
    decoder stage with its head (the last: the main head)."""
    out = [(f"{prefix}initial", path + ("Conv_0",), "conv")]
    for j in range(5):
        out += _double_conv_map(f"{prefix}enc.{j}.",
                                path + (f"_ConvStage_{j}",))
        out += _sda_map(None, f"{prefix}enc_sda.{j}.", path + (f"SDA_{j}",))
    heads = [f"heads.{j}" for j in range(4)] + ["main"]
    for k in range(4):
        out += _double_conv_map(f"{prefix}dec.{k}.",
                                path + (f"_ConvStage_{k + 5}",))
        out += _sda_map(None, f"{prefix}dec_sda.{k}.",
                        path + (f"SDA_{k + 5}",))
    return out + [(f"{prefix}{h}", path + (f"Conv_{j + 1}",), "conv")
                  for j, h in enumerate(heads)]


def _masood_map(m, prefix, path) -> list:
    out = []
    for i, b in enumerate(m.branches):
        n = len(b.convs)
        out += _pairs(f"{prefix}branches.{i}.", path + (f"CNNBranch_{i}",),
                      [f"convs.{j}" for j in range(n)],
                      [f"bns.{j}" for j in range(n)])
    return out + [(f"{prefix}head", path + ("Conv_0",), "conv")]


def _conv_bn_act_map(m, prefix, path) -> list:
    out = [(f"{prefix}conv", path + ("Conv_0",), "conv")]
    if m.bn is not None:
        out.append((f"{prefix}bn", path + ("BatchNorm_0",), "bn"))
    return out


def _blocks_double_conv_map(m, prefix, path) -> list:
    return [e for j, b in enumerate(m.blocks)
            for e in _conv_bn_act_map(b, f"{prefix}blocks.{j}.",
                                      path + (f"ConvBNAct_{j}",))]


def _attention_gate_map(m, prefix, path) -> list:
    return [e for j, n in enumerate(("w_g", "w_x", "psi"))
            for e in _conv_bn_act_map(getattr(m, n), f"{prefix}{n}.",
                                      path + (f"ConvBNAct_{j}",))]


def _blocks_aspp_map(m, prefix, path) -> list:
    out = [e for j, b in enumerate(m.branches)
           for e in _conv_bn_act_map(b, f"{prefix}branches.{j}.",
                                     path + (f"ConvBNAct_{j}",))]
    return out + [(f"{prefix}project", path + ("Conv_0",), "conv")]


def _separable_conv_map(m, prefix, path) -> list:
    return [(f"{prefix}depthwise", path + ("Conv_0",), "conv"),
            (f"{prefix}pointwise", path + ("Conv_1",), "conv")]


def _prelu_map(m, prefix, path) -> list:
    return [(prefix[:-1], path, "prelu")]


def _backbone_map(m, prefix, path) -> list:
    return backbone_layer_map(len(m.enc), m.att is not None, prefix, path)


def layer_map(module, prefix: str = "", path: tuple = ()) -> list:
    """The layer map of a port module of the FFC stack or the zoo (Y-Net,
    EdgeAL, AnoGAN, FourierNet, MGU-Net, ISLAM, LightReSeg, MSNet, LossNet,
    BioNet, WAT-Net, RetiFluidNet, Masood, their backbones and attention
    units, an FFC unit, a wrapper), of a generic block of
    ``models/blocks`` or of SD_Layer_Net's U-Net, its names under
    ``prefix`` and its Flax modules under ``path``, read off the module:
    which paths exist follows the channel splits it was built with, and
    Flax numbers each kind of submodule in call order."""
    for cls, fn in _MAPS:
        if isinstance(module, cls):
            return fn(module, prefix, path)
    raise TypeError(f"no layer map for {type(module).__name__}")


_MAPS = ((ffc.FourierUnit, _fourier_unit_map),
         (ffc.SpectralTransform, _spectral_map),
         (ffc.FFC, _ffc_map),
         (ffc.FFC_BN_ACT, _ffc_bn_act_map),
         (ffc.FFCResnetBlock, _resnet_block_map),
         (ffc.FFCSEBlock, _se_block_map),
         (ffc.LearnableSpatialTransformWrapper, _spatial_wrapper_map),
         (YNet, _ynet_map),
         (EdgeAL, _edgeal_map),
         (AnoGAN, _anogan_map),
         (FourierNet, _fouriernet_map),
         (MGUNet, _mgunet_map),
         (ISLAM, _islam_map),
         (LightReSeg, _lightreseg_map),
         (Bottle2neck, _bottle2neck_map),
         (Res2Net50Features, _res2net_map),
         (MSNet, _msnet_map),
         (LossNet, _lossnet_map),
         (BasicBlock, _resnet_unit_map),
         (ResNetFeatures, _resnet_map),
         (BioNet, _bionet_map),
         (WAT, _wat_map),
         (WATNet, _watnet_map),
         (SDA, _sda_map),
         (RetiFluidNet, _retifluidnet_map),
         (Masood2024, _masood_map),
         (blocks.ConvBNAct, _conv_bn_act_map),
         (blocks.DoubleConv, _blocks_double_conv_map),
         (blocks.SqueezeExcitation, lambda m, p, path: _se_map(p, path)),
         (blocks.AttentionGate, _attention_gate_map),
         (blocks.ASPP, _blocks_aspp_map),
         (blocks.SeparableConv, _separable_conv_map),
         (blocks.PReLU, _prelu_map),
         (UNetBackbone, _backbone_map))


# -- the two directions ------------------------------------------------------

# kind -> (Flax module name inside the path's node or None, kernel
# transpose to the port's layout); a bias is carried where the layer has one
_KERNELS = {"conv": ("Conv_0", (3, 2, 0, 1)), "dense": (None, (1, 0)),
            "ct": (None, (2, 3, 0, 1))}


def _node(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _key(name: str, leaf: str) -> str:
    return ".".join(part for part in (name, leaf) if part)


def state_dict_from_jax(variables, layer_map) -> OrderedDict:
    """JAX variables {"params"[, "batch_stats"]} -> the state dict of the
    port module that ``layer_map`` describes: [(port module name, Flax
    module path, kind)], kind "conv" (a ``Conv`` wrapper: kernel (kh, kw,
    in, out) -> (out, in, kh, kw)), "dense" ((in, out) -> (out, in)), "ct"
    (a ``ConvTranspose``: (k, k, in, out) -> (in, out, k, k)), "bn"
    (a ``BatchNorm`` wrapper), "bare_bn" (a flax ``BatchNorm`` itself),
    "norm" (a flax ``GroupNorm`` or ``LayerNorm``: scale, bias -> weight,
    bias), "prelu" (``alpha`` -> weight), "angle" (the spatial-transform
    wrapper's ``angle``) or "param" (a bare parameter, the path's last
    entry, under the port name itself)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = OrderedDict()
    for name, path, kind in layer_map:
        p = _node(params, path)
        if kind in ("bn", "bare_bn"):
            s = _node(stats, path)
            if kind == "bn":
                s, p = s["BatchNorm_0"], p["BatchNorm_0"]
            for leaf, v in (("weight", p["scale"]), ("bias", p["bias"]),
                            ("running_mean", s["mean"]),
                            ("running_var", s["var"])):
                sd[_key(name, leaf)] = _t(v)
            sd[_key(name, "num_batches_tracked")] = torch.tensor(0)
        elif kind == "norm":
            sd[_key(name, "weight")] = _t(p["scale"])
            sd[_key(name, "bias")] = _t(p["bias"])
        elif kind == "prelu":
            sd[_key(name, "weight")] = _t(p["alpha"])
        elif kind == "angle":
            sd[_key(name, "angle")] = _t(p["angle"])
        elif kind == "param":
            sd[_key(name, "")] = _t(p)
        else:
            inner, perm = _KERNELS[kind]
            if inner is not None:
                p = p[inner]
            sd[_key(name, "weight")] = _t(p["kernel"], perm)
            if "bias" in p:
                sd[_key(name, "bias")] = _t(p["bias"])
    return sd


def variables_from_state_dict(state_dict, layer_map) -> dict:
    """The inverse of ``state_dict_from_jax``: JAX variables {"params",
    "batch_stats"} as float32 numpy arrays ("batch_stats" only where the
    map has a BatchNorm)."""
    def a(name, leaf, perm=None):
        v = state_dict[_key(name, leaf)].detach().cpu().float().numpy()
        return v.transpose(perm) if perm is not None else v

    def put(tree, path, leaf):
        for k in path:
            tree = tree.setdefault(k, {})
        tree.update(leaf)

    params, stats = {}, {}
    for name, path, kind in layer_map:
        if kind in ("bn", "bare_bn"):
            inner = ("BatchNorm_0",) if kind == "bn" else ()
            put(params, path + inner, {
                "scale": a(name, "weight"), "bias": a(name, "bias")})
            put(stats, path + inner, {
                "mean": a(name, "running_mean"),
                "var": a(name, "running_var")})
        elif kind == "norm":
            put(params, path, {"scale": a(name, "weight"),
                               "bias": a(name, "bias")})
        elif kind == "param":
            put(params, path[:-1], {path[-1]: a(name, "")})
        elif kind == "prelu":
            put(params, path, {"alpha": a(name, "weight")})
        elif kind == "angle":
            put(params, path, {"angle": a(name, "angle")})
        else:
            inner, perm = _KERNELS[kind]
            leaf = {"kernel": a(name, "weight", tuple(np.argsort(perm)))}
            if _key(name, "bias") in state_dict:
                leaf["bias"] = a(name, "bias")
            put(params, path + ((inner,) if inner else ()), leaf)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


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
