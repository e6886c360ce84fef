"""Configuration dataclasses and ``flat_update``: the JAX package's
``config.py``, with the same names and defaults, for the fields the ported
paths read."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence


@dataclasses.dataclass
class ModelConfig:
    """Which architecture to build and its constructor overrides."""

    name: str = "unet"
    in_channels: int = 1
    num_classes: int = 10
    # per-architecture kwargs forwarded to the registry constructor
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OptimConfig:
    optimizer: str = "adam"  # adam | adamw | sgd | adadelta
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    momentum: float = 0.9
    grad_clip_norm: float | None = None
    # linear warmup steps, then cosine decay to lr_min_ratio * learning_rate
    warmup_steps: int = 0
    decay_steps: int | None = None
    lr_min_ratio: float = 0.0


@dataclasses.dataclass
class DataConfig:
    image_size: tuple[int, int] = (512, 512)
    batch_size: int = 8
    # preprocessing on the device (ops/preprocess.py)
    flatten_retina: bool = False
    denoise: bool = False
    normalize: bool = True  # per-image z-score
    num_train: int = 128
    num_val: int = 16


@dataclasses.dataclass
class TrainConfig:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    optim: OptimConfig = dataclasses.field(default_factory=OptimConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    loss: str = "dice_ce"
    class_weights: Sequence[float] | None = None
    num_epochs: int = 10
    steps_per_epoch: int | None = None
    eval_every_epochs: int = 1
    # early stopping on the validation loss: best state + patience
    early_stop_patience: int | None = 50
    checkpoint_dir: str | None = None
    keep_checkpoints: int = 1
    seed: int = 0
    # compute dtype ("float32" | "bfloat16" | "float16"); params stay fp32
    compute_dtype: str = "bfloat16"
    # the U-Net's training forward on the CUDA kernels
    # (training/packed_unet.py); "remat" also checkpoints each block
    packed_train: bool | str = False
    # mesh axis sizes ({"data": d, "space": s}); data parallelism over
    # "data" (parallel/mesh.py)
    mesh_shape: Mapping[str, int] | None = None


def flat_update(cfg: Any, updates: Mapping[str, Any]) -> Any:
    """A copy of a (nested) dataclass with dotted-key updates:
    ``flat_update(cfg, {"optim.learning_rate": 3e-4})``."""
    for key, value in updates.items():
        parts = key.split(".")
        chain = []
        node = cfg
        for p in parts[:-1]:
            chain.append((node, p))
            node = getattr(node, p)
        node = dataclasses.replace(node, **{parts[-1]: value})
        for parent, attr in reversed(chain):
            node = dataclasses.replace(parent, **{attr: node})
        cfg = node
    return cfg
