"""Model registry: name -> PyTorch module constructor, the JAX package's 18
names. Each constructor takes ``in_channels``, ``num_classes``, ``seed`` and
``device``; an unknown name raises ``ValueError`` listing the names."""

from __future__ import annotations

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


def list_models() -> list[str]:
    return sorted(_MODELS)


def get_model(name: str, **kwargs: Any):
    """Build a model by registry name (the JAX package's names)."""
    if name not in _MODELS:
        raise ValueError(
            f"Unknown model {name!r}. Available: {', '.join(list_models())}")
    return _MODELS[name](**kwargs)
