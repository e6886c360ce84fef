"""Quantized-serving artifacts: the U-Net's int8 and w4a4 qparams in one
``.npz``.

The file format is the JAX package's (``inference/artifacts.py``): leaf
arrays under path-encoded keys, dict segments joined by ``\\x1f`` and
tuple slots written ``[i]``; no pickle (``np.load(allow_pickle=False)``).
The port writes the raw qparams in the JAX layout (weights (kh, kw, cin,
cout), float32 scales, ``_act_scales``; for the w4a4 mode also ``wsum4``
and the mode keys ``_deep_*``, ``_w8_*``) plus a ``_mode`` key, and
rebuilds the kernels' parameters when it loads, so an int8 artifact written
here is also one the JAX package serves. It reads JAX artifacts of mode
int8, psrp, packed and int4, taking ``w_q``, ``s_w``, ``b``, ``wsum4``,
``_act_scales`` and the mode keys and leaving the TPU packs.

An artifact's mode comes from its ``_mode`` key, or for a JAX artifact from
its keys: ``w_psrp`` packs mean psrp, ``w_packed_by`` packs mean packed, a
``_deep_*`` flag means the w4a4 variant of psrp (``int4``), none of these
int8. ``load_qparams`` refuses an artifact whose mode is not the one asked
for (the JAX CLI does not check, ``cli.py:233``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.convert import MODE_KEY_PREFIXES, unet_qparams_from_jax

_SEP = "\x1f"  # key-segment separator (never appears in layer names)
MODES = ("int8", "psrp", "packed", "int4")


def _jax_layout(w_q: torch.Tensor, name: str) -> np.ndarray:
    """Port weights -> the JAX (kh, kw, cin, cout) layout."""
    perm = (2, 3, 0, 1) if name.startswith("ct") else (2, 3, 1, 0)
    return w_q.detach().cpu().numpy().transpose(perm)


def save_qparams(path: str, qparams: dict, mode: str) -> None:
    """Write the U-Net qparams of ``mode`` (raw, or with the kernels'
    parameters attached: only w_q, s_w, b and ``_act_scales`` are kept) to
    ``path`` (.npz)."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {', '.join(MODES)}")
    flat = {"_mode": np.asarray(mode)}
    for key, v in qparams["_act_scales"].items():
        flat[_SEP.join(("_act_scales", key))] = np.float32(float(v))
    for name, lw in qparams.items():
        if name.startswith(MODE_KEY_PREFIXES):
            flat[name] = np.asarray(True)
        if name.startswith("_"):
            continue
        flat[_SEP.join((name, "w_q"))] = _jax_layout(lw["w_q"], name)
        for leaf in ("s_w", "b", "wsum4"):
            if leaf in lw:
                flat[_SEP.join((name, leaf))] = \
                    lw[leaf].detach().cpu().numpy().astype(np.float32)
    np.savez(path, **flat)


def artifact_mode(keys) -> str:
    """The mode of a JAX artifact (one without ``_mode``) from its npz
    keys."""
    segs = [k.split(_SEP) for k in keys]
    if any(s[0].startswith("_deep_") for s in segs):
        return "int4"
    leaves = {s[1] for s in segs if len(s) > 1 and not s[0].startswith("_")}
    if "w_psrp" in leaves:
        return "psrp"
    if "w_packed_by" in leaves:
        return "packed"
    return "int8"


def load_qparams(path: str, mode: str) -> dict:
    """Read an artifact of ``mode`` (written here or by the JAX package) ->
    the raw qparams on the CPU. Raises if the artifact is of another
    mode."""
    with np.load(path, allow_pickle=False) as z:
        items = {k: z[k] for k in z.files}
    found = (str(items.pop("_mode")) if "_mode" in items
             else artifact_mode(items))
    if found != mode:
        raise ValueError(
            f"{path}: a {found} artifact, but --quantize {mode} was asked "
            f"for")
    tree: dict = {}
    for key, val in items.items():
        segs = key.split(_SEP)
        if len(segs) == 1 and key.startswith(MODE_KEY_PREFIXES):
            tree[key] = True
        if len(segs) != 2:
            continue  # TPU packs: tuple slots and the like
        node, leaf = segs
        if node.startswith("_") and node != "_act_scales":
            continue
        if leaf in ("w_q", "s_w", "b", "wsum4") or node == "_act_scales":
            tree.setdefault(node, {})[leaf] = val
    return unet_qparams_from_jax(tree)
