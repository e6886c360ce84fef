"""PyTorch + CUDA port of the retinal OCT segmentation framework.

The JAX package ``retinal_oct_image_segmentation_via_deep_learning_tpu``
beside this one is the reference; this package holds the int8 U-Net serving
path for an NVIDIA Hopper card. Its kernels are hand-written CUDA
(``csrc/``), built with ``nvcc`` on first use (``ops/_build.py``); each has
a plain PyTorch version that CPU tensors take.

Importing the package imports ``torch`` and numpy only.
"""

from .config import DataConfig, ModelConfig
from .registry import get_model, list_models

__all__ = ["DataConfig", "ModelConfig", "get_model", "list_models"]
