"""Model registry: name -> PyTorch module constructor.

The U-Net and ReLayNet are ported so far; every other name of the JAX
package's zoo raises ``NotImplementedError`` until its slice lands
(ROADMAP.md, Queue A).
"""

from __future__ import annotations

from typing import Any, Callable

from .models.relaynet import build_relaynet
from .models.unet import build_unet

_MODELS: dict[str, Callable[..., Any]] = {"relaynet": build_relaynet,
                                          "unet": build_unet}


def list_models() -> list[str]:
    return sorted(_MODELS)


def get_model(name: str, **kwargs: Any):
    """Build a model by registry name (same names as the JAX package)."""
    if name not in _MODELS:
        raise NotImplementedError(
            f"model {name!r} is not ported to PyTorch yet (ported: "
            f"{', '.join(list_models())}); see ROADMAP.md, Queue A"
        )
    return _MODELS[name](**kwargs)
