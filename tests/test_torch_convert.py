"""Guards of the PyTorch port's boundaries: weights cross between the two
packages in both directions, and ``jax`` never leaks into the port."""

import subprocess
import sys

import numpy as np
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.models.unet import (
    UNet as JaxUNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.utils.torch_compat import (
    import_torch_state,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    UNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_state_dict_from_jax,
    unet_variables_from_state_dict,
)
from test_torch_common import jax_unet


def torch_generator(seed):
    return torch.Generator().manual_seed(seed)


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


def test_reverse_conversion_matches_import_torch_state():
    """Port state dict -> JAX layout by ``unet_variables_from_state_dict``
    equals the JAX package's own importer, leaf for leaf."""
    _, v = jax_unet(8, nc=5, hw=32)
    model = UNet(1, 5, 8, generator=torch_generator(3))
    want = import_torch_state(v, model.state_dict(),
                              transposed=lambda n: "upconv" in n)
    got = unet_variables_from_state_dict(model.state_dict())
    want = jax.tree_util.tree_leaves_with_path(want)
    got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(got[path], np.asarray(leaf), str(path))


def test_checkpoint_block_spelling():
    """A JAX U-Net built with ``remat_stages=True`` names its blocks
    ``CheckpointUNetBlock_N``: the converter reads that spelling and writes
    it on request, with the tree JAX builds."""
    jm = JaxUNet(out_channels=5, init_features=8, remat_stages=True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 1)))
    model = UNet(1, 5, 8, generator=torch_generator(4))
    v = unet_variables_from_state_dict(model.state_dict(), remat_stages=True)
    want = {jax.tree_util.keystr(k): leaf.shape for k, leaf in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = {jax.tree_util.keystr(k): leaf.shape for k, leaf in
           jax.tree_util.tree_leaves_with_path(v)}
    assert got == want
    assert any("CheckpointUNetBlock_0" in k for k in got)
    back = unet_state_dict_from_jax(v)
    for k, t in model.state_dict().items():
        assert np.array_equal(back[k].numpy(), t.numpy()), k


def test_port_imports_without_jax():
    """A fresh interpreter with ``jax`` and the JAX package blocked imports
    every module of the port, the fused-loss, ReLayNet, fused-stem, packed
    graph, artifact, metric and CLI modules among them; neither is loaded
    afterwards."""
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
        "print(' '.join(mods))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    mods = set(out.stdout.split())
    assert len(mods) >= 43
    pkg = "retinal_oct_image_segmentation_via_deep_learning_tpu_torch."
    for name in ("ops.dice_ce", "ops.conv7x3_int8", "ops.pooling",
                 "models.relaynet", "inference.relaynet_int8",
                 "inference.relaynet_psrp", "ops.stem_conv_int8",
                 "inference.packed", "inference.artifacts",
                 "metrics.contour", "metrics.volume", "metrics.region",
                 "cli"):
        assert pkg + name in mods, name
