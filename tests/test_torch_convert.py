"""Guards of the PyTorch port's boundaries: weights cross between the two
packages in both directions, and ``jax`` never leaks into the port."""

import subprocess
import sys

import numpy as np

import jax

from retinal_oct_image_segmentation_via_deep_learning_tpu.utils.torch_compat import (
    import_torch_state,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    UNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
)
from test_torch_common import jax_unet


def test_state_dict_round_trip():
    """JAX variables -> port state dict -> loaded into the port U-Net ->
    its state_dict -> import_torch_state -> the same JAX variables."""
    _, v = jax_unet(8, nc=5, hw=32)
    model = UNet(1, 5, 8)
    model.load_state_dict(unet_state_dict_from_jax(v))
    back = import_torch_state(v, model.state_dict(),
                              transposed=lambda n: "upconv" in n)
    want = jax.tree_util.tree_leaves_with_path(v)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(got[path]), leaf, str(path))


def test_port_imports_without_jax():
    """A fresh interpreter with ``jax`` and the JAX package blocked imports
    every module of the port; neither is loaded afterwards."""
    code = (
        "import importlib, pkgutil, sys\n"
        "JAX_PKG = 'retinal_oct_image_segmentation_via_deep_learning_tpu'\n"
        "for name in ('jax', 'jaxlib', 'flax', JAX_PKG):\n"
        "    sys.modules[name] = None\n"
        "import retinal_oct_image_segmentation_via_deep_learning_tpu_torch "
        "as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = [k for k, v in sys.modules.items() if v is not None and "
        "k.split('.')[0] in ('jax', 'jaxlib', 'flax', JAX_PKG)]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 12
