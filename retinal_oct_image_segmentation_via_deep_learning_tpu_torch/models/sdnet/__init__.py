from .layer_engine import LayerEngine  # noqa: F401
from .sdnet import SDNet, build_sdnet  # noqa: F401
