"""JAX U-Net weights -> this package's U-Net state dict (and qparams).

The reverse direction is the JAX package's
``utils/torch_compat.import_torch_state(variables, state_dict,
transposed=lambda n: "upconv" in n)``. Inputs are numpy arrays (or
anything ``np.asarray`` takes); nothing of JAX is imported.

Layouts: conv kernel (kh, kw, in, out) -> weight (out, in, kh, kw);
ConvTranspose kernel (k, k, in, out) -> weight (in, out, k, k) (the JAX
package stores it like torch, flipped at use); BatchNorm scale, bias,
mean, var -> weight, bias, running_mean, running_var.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

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
        p, st = params[f"UNetBlock_{i}"], stats[f"UNetBlock_{i}"]
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


def unet_qparams_from_jax(qparams) -> dict:
    """JAX int8 qparams (``quantize_unet`` / ``quantize_unet_psrp``: w_q,
    s_w, b and ``_act_scales``) -> this package's layout, on the CPU.
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
