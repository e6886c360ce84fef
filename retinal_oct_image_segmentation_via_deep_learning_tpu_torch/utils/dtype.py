"""Dtype policy: float32 parameters, optional bf16 or fp16 compute (the JAX
package's ``utils/dtype.py``).

``DTypePolicy`` holds torch dtypes. JAX's ``flax_kwargs`` (``dtype=`` and
``param_dtype=`` for every Flax layer) has no counterpart in the port's
models, which take no dtype: their parameters are float32, and the
compute dtype is applied around the forward as autocast
(``training/trainer.nhwc_logits``, which the Trainer calls with
``resolve_dtype(cfg.compute_dtype)``).
"""

from __future__ import annotations

import dataclasses

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str | torch.dtype) -> torch.dtype:
    return _DTYPES[name] if isinstance(name, str) else name


@dataclasses.dataclass(frozen=True)
class DTypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    @classmethod
    def create(cls, compute: str | torch.dtype = "float32") -> "DTypePolicy":
        return cls(param_dtype=torch.float32,
                   compute_dtype=resolve_dtype(compute))
