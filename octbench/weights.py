"""Seeded weights of a configuration, made on the device.

Two draws from a ``torch.Generator`` on the device (one uniform, one
normal, each as long as all the tensors together), cut into the tensors of
the ``param_spec`` of the configuration's reference module. The
distributions are the program's own initialisation (weights:
U(-1, 1)/sqrt(fan_in), biases alike) with random BatchNorm terms (weight
U(0.5, 1.5), bias and running mean N(0, 0.1), running variance
U(0.5, 1.5)) and PReLU slopes U(0.5, 1), so that the served labels spread
over the classes; the configuration's ``gains`` scale the weights of each
kind (a spec's kind other than those below names a kind of weight).
"""

from __future__ import annotations

import math

import torch

from . import harness

# kinds that are not weights; any other kind is a weight of that kind
NOT_WEIGHTS = ("bias", "bn_weight", "bn_var", "bn_bias", "bn_mean", "prelu")


def make(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for configuration ``cfg``."""
    spec = harness.reference(cfg).param_spec(cfg)
    sizes = [math.prod(shape) for _, shape, _ in spec]
    total = sum(sizes)
    g = torch.Generator(device=device).manual_seed(seed)
    uni = torch.rand(total, generator=g, device=device)
    nrm = torch.randn(total, generator=g, device=device)
    gains = cfg.get("weights", {}).get("gains", {})
    out, at, fan = {}, 0, 1
    for (name, shape, kind), n in zip(spec, sizes):
        u, z = uni[at:at + n].view(shape), nrm[at:at + n].view(shape)
        at += n
        if kind not in NOT_WEIGHTS:
            # torch's fan_in: weight dim 1 times the kernel area
            fan = math.prod(shape[1:])
            t = (2 * u - 1) * (gains.get(kind, 1.0) / math.sqrt(fan))
        elif kind == "bias":
            t = (2 * u - 1) / math.sqrt(fan)  # the preceding weight's
        elif kind in ("bn_weight", "bn_var"):
            t = 0.5 + u
        elif kind in ("bn_bias", "bn_mean"):
            t = 0.1 * z
        else:  # prelu
            t = 0.5 + 0.5 * u
        out[name] = t.contiguous()
    return out
