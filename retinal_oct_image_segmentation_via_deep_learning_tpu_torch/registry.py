"""Model registry: name -> PyTorch module constructor, the JAX package's 18
names. Each constructor takes ``in_channels``, ``num_classes``, ``seed`` and
``device``; an unknown name raises ``ValueError`` listing the names.
``register_model`` (also a decorator) and ``register_lazy`` add names, as
the JAX package's do."""

from __future__ import annotations

import importlib
from typing import Any, Callable

from .models.anogan import build_anogan
from .models.bionet import build_bionet
from .models.edgeal import build_edgeal
from .models.fouriernet import build_fouriernet
from .models.islam import build_islam
from .models.lightreseg import build_lightreseg
from .models.masood import build_masood
from .models.mgunet import build_mgunet, build_mgunet_2
from .models.msnet import build_m2snet, build_msnet
from .models.relaynet import build_relaynet
from .models.retifluidnet import build_retifluidnet
from .models.sdnet import build_sdnet
from .models.unet import build_unet, build_ynet, build_ynet_ffc
from .models.watnet import build_watnet

_MODELS: dict[str, Callable[..., Any]] = {
    "anogan": build_anogan,
    "bionet": build_bionet,
    "edgeal": build_edgeal,
    "fouriernet": build_fouriernet,
    "islam": build_islam,
    "lightreseg": build_lightreseg,
    "m2snet": build_m2snet,
    "masood": build_masood,
    "mgunet": build_mgunet,
    "mgunet_2": build_mgunet_2,
    "msnet": build_msnet,
    "relaynet": build_relaynet,
    "retifluidnet": build_retifluidnet,
    "sdnet": build_sdnet,
    "unet": build_unet,
    "watnet": build_watnet,
    "y_net_gen": build_ynet,
    "y_net_gen_ffc": build_ynet_ffc,
}


# name -> (module path under .models, attribute), imported on first use
_LAZY: dict[str, tuple[str, str]] = {}


def register_model(name: str, ctor: Callable[..., Any] | None = None):
    """Register a model constructor under ``name``; without ``ctor``, a
    decorator."""

    def wrap(fn: Callable[..., Any]):
        _MODELS[name] = fn
        return fn

    return wrap(ctor) if ctor is not None else wrap


def register_lazy(name: str, module: str, attr: str) -> None:
    """Register ``models.<module>.<attr>`` under ``name``, imported when
    the model is first built."""
    _LAZY[name] = (module, attr)


def list_models() -> list[str]:
    return sorted(set(_MODELS) | set(_LAZY))


def get_model(name: str, **kwargs: Any):
    """Build a model by registry name (the JAX package's names)."""
    if name not in _MODELS and name in _LAZY:
        module, attr = _LAZY[name]
        _MODELS[name] = getattr(importlib.import_module(
            f".models.{module}", package=__package__), attr)
    if name not in _MODELS:
        raise ValueError(
            f"Unknown model {name!r}. Available: {', '.join(list_models())}")
    return _MODELS[name](**kwargs)
