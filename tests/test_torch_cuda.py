"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; every test skips where there is no CUDA device (the check
is made in a fixture, at run time). On a machine with the card, and without
JAX (hence ``--noconftest``):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
    build_model,
    build_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
    unet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_int8 as k12,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    head_argmax as k3,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
    preprocess,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _i8(rng, shape, dev, lo=-127, hi=128):
    return torch.tensor(rng.integers(lo, hi, shape), dtype=torch.int8,
                        device=dev)


def _vec(rng, n, lo, hi, dev):
    return torch.tensor(rng.uniform(lo, hi, n), dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("n,h,w,cins,cout,pool,relu", [
    (2, 8, 8, (1,), 8, True, True),        # stem Cin=1
    (1, 6, 10, (5,), 3, False, True),      # odd channel counts, partial tile
    (2, 16, 16, (8, 8), 40, True, True),   # two inputs, cout % 32 != 0
    (1, 34, 18, (32,), 64, True, False),   # several tiles, no relu
    (1, 7, 9, (64, 32), 32, False, True),  # odd H, W
])
def test_k1_matches_plain(dev, n, h, w, cins, cout, pool, relu):
    rng = np.random.default_rng(0)
    xs = tuple(_i8(rng, (n, h, w, c), dev) for c in cins)
    wk = k12.pack_conv3x3_weights(_i8(rng, (cout, sum(cins), 3, 3), dev,
                                      -40, 40))
    sc, b = _vec(rng, cout, 1e-4, 3e-4, dev), _vec(rng, cout, -5, 5, dev)
    before = k12.conv3x3_int8.launches
    got = k12.conv3x3_int8(xs, wk, sc, b, relu=relu, pool=pool)
    want = k12.conv3x3_int8_reference(xs, wk, sc, b, relu=relu, pool=pool)
    torch.cuda.synchronize()
    assert k12.conv3x3_int8.launches == before + 1
    for g_, w_ in zip(got if pool else (got,), want if pool else (want,)):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("n,h,w,cin,cout", [
    (2, 4, 4, 16, 8), (1, 3, 5, 12, 5), (2, 8, 8, 64, 32),
])
def test_k2_matches_plain(dev, n, h, w, cin, cout):
    rng = np.random.default_rng(1)
    x = _i8(rng, (n, h, w, cin), dev)
    wk = k12.pack_ct2x2_weights(_i8(rng, (cin, cout, 2, 2), dev, -40, 40))
    sc, b = _vec(rng, cout, 1e-4, 3e-4, dev), _vec(rng, cout, -5, 5, dev)
    assert torch.equal(k12.ct2x2_int8(x, wk, sc, b),
                       k12.ct2x2_int8_reference(x, wk, sc, b))


def test_k3_matches_plain_with_tie(dev):
    rng = np.random.default_rng(2)
    x = _i8(rng, (2, 8, 8, 32), dev)
    x[0, 0] = 0
    wk = k3.pack_head_weights(_i8(rng, (10, 32, 1, 1), dev, -40, 40))
    sc, b = _vec(rng, 10, 1e-3, 2e-3, dev), _vec(rng, 10, -1, 1, dev)
    b[3] = b[7] = 5.0
    got = k3.head_argmax(x, wk, sc, b)
    assert torch.equal(got, k3.head_argmax_reference(x, wk, sc, b))
    assert bool((got[0, 0] == 3).all())


def test_wrapper_rejects_bad_input(dev):
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device=dev)
    wk = k12.pack_conv3x3_weights(torch.zeros((8, 8, 3, 3),
                                              dtype=torch.int8, device=dev))
    sc = torch.ones(8, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k12.conv3x3_int8(x.transpose(1, 2), wk, sc, sc)
    with pytest.raises(ValueError, match="weights"):
        k12.conv3x3_int8(x, wk[:, :1], sc, sc)


def test_graph_kernels_match_plain(dev):
    model = build_model(num_classes=5, init_features=8, seed=0, device=dev)
    forward, calib = build_psrp_forward(model, image_size=64, device=dev)
    x = preprocess(torch.tensor(
        np.random.default_rng(3).uniform(0, 255, (3, 64, 64, 1)),
        dtype=torch.float32, device=dev,
    ))
    with torch.inference_mode():
        got = unet_psrp_forward(calib["qparams"], x, 5)
        want = unet_psrp_forward(calib["qparams"], x, 5, reference=True)
    assert got.shape == (3, 64, 64) and got.dtype == torch.int8
    assert torch.equal(got, want)
