"""Configuration dataclasses (the fields the serving path reads)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class ModelConfig:
    """Which architecture to build."""

    name: str = "unet"
    in_channels: int = 1
    num_classes: int = 10


@dataclasses.dataclass
class DataConfig:
    image_size: tuple[int, int] = (512, 512)
    normalize: bool = True  # per-image z-score (ops/preprocess.py)
