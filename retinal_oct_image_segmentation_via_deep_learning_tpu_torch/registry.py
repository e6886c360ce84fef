"""Model registry: name -> PyTorch module constructor.

Twelve names of the JAX package's zoo are ported: the U-Net, ReLayNet,
SDNet, Y-Net (plain and FFC), FourierNet, AnoGAN, EdgeAL, MGU-Net (both
variants), ISLAM and LightReSeg; every other
name raises ``NotImplementedError`` until its slice lands (ROADMAP.md,
Queue A). Each builder takes ``in_channels``, ``num_classes``, ``seed`` and
``device``.
"""

from __future__ import annotations

from typing import Any, Callable

from .models.anogan import build_anogan
from .models.edgeal import build_edgeal
from .models.fouriernet import build_fouriernet
from .models.islam import build_islam
from .models.lightreseg import build_lightreseg
from .models.mgunet import build_mgunet, build_mgunet_2
from .models.relaynet import build_relaynet
from .models.sdnet import build_sdnet
from .models.unet import build_unet, build_ynet, build_ynet_ffc

_MODELS: dict[str, Callable[..., Any]] = {
    "anogan": build_anogan,
    "edgeal": build_edgeal,
    "fouriernet": build_fouriernet,
    "islam": build_islam,
    "lightreseg": build_lightreseg,
    "mgunet": build_mgunet,
    "mgunet_2": build_mgunet_2,
    "relaynet": build_relaynet,
    "sdnet": build_sdnet,
    "unet": build_unet,
    "y_net_gen": build_ynet,
    "y_net_gen_ffc": build_ynet_ffc,
}


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
