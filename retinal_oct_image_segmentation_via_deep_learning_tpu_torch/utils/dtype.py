"""Dtype policy: float32 parameters, optional bf16 or fp16 compute (the JAX
package's ``utils/dtype.resolve_dtype``)."""

from __future__ import annotations

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
