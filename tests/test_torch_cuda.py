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
    build_relaynet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
    unet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.relaynet_psrp import (
    relaynet_psrp_forward,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    column_softargmax as k12sm,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv7x3_int8 as k7,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_bf16 as k45,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    conv_int8 as k12,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    dice_ce as k89,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    fused_bn as k6,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
    head_argmax as k3,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.preprocess import (
    preprocess,
)
from test_torch_k3_mma import crafted_case as k3_case
from test_torch_k6_order import SHAPES as K6_ORDER_SHAPES
from test_torch_k6_order import emulate as k6_emulate

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


# K2's tensor-core body at the served forward's four calls (f=32, batch 2)
# and at odd shapes: (n, h, w, cin, cout, mode, misaligned input)
K2_CASES = [
    (2, 32, 32, 512, 256, "int8", False), (2, 64, 64, 256, 128, "int8", False),
    (2, 128, 128, 128, 64, "int8", False), (2, 256, 256, 64, 32, "int8", False),
    (2, 32, 32, 512, 256, "w4a4", False), (2, 64, 64, 256, 128, "w4a4", False),
    (2, 5, 7, 96, 40, "int8", False),     # edge tile, cout % 16 != 0
    (1, 3, 10, 48, 40, "w4a4", False),    # cin % 32 = 16
    (2, 9, 9, 64, 32, "int8", True),      # the byte gatherer
    (1, 4, 4, 12, 5, "w4a4", False),
]


def _k2_args(rng, dev, n, h, w, cin, cout, mode, misaligned=False):
    four = mode == "w4a4"
    lo, hi = (-7, 8) if four else (-127, 128)
    x = _i8(rng, (n * h * w * cin + 4,), dev, lo, hi)
    x = (x[4:] if misaligned else x[:-4]).view(n, h, w, cin)
    wk = k12.pack_ct2x2_weights(_i8(rng, (cin, cout, 2, 2), dev, lo, hi))
    std = cin ** 0.5 * (16 if four else 73 ** 2)
    sc = _vec(rng, cout, (3 if four else 30) / std, (6 if four else 60) / std,
              dev)
    b = _vec(rng, 4 * cout if four else cout, -3, 3, dev)
    return x, wk, sc, b, 7.0 if four else 127.0


@pytest.mark.parametrize("n,h,w,cin,cout,mode,misaligned", K2_CASES)
def test_k2_mma_matches_plain(dev, n, h, w, cin, cout, mode, misaligned):
    """The tensor-core body bit for bit against the plain version, one
    launch a call; the w4a4 knobs (per-column bias, clip 7)."""
    rng = np.random.default_rng(30)
    x, wk, sc, b, clip = _k2_args(rng, dev, n, h, w, cin, cout, mode,
                                  misaligned)
    assert (x.data_ptr() % 16 != 0) == misaligned
    before = k12.ct2x2_int8.launches
    got = k12.ct2x2_int8(x, wk, sc, b, out_clip=clip)
    torch.cuda.synchronize()
    assert k12.ct2x2_int8.launches == before + 1
    want = k12.ct2x2_int8_reference(x, wk, sc, b, out_clip=clip)
    assert torch.equal(got, want)
    assert len(torch.unique(want)) > 3
    if clip == 7.0:
        assert int(got.abs().max()) == 7


@pytest.mark.parametrize("h,cin,cout", [(32, 512, 256), (256, 64, 32)])
def test_k2_repeat_calls_identical(dev, h, cin, cout):
    """Two calls on the same inputs give the same bits (ct0 and ct3)."""
    rng = np.random.default_rng(31)
    x, wk, sc, b, _ = _k2_args(rng, dev, 2, h, h, cin, cout, "int8")
    first = k12.ct2x2_int8(x, wk, sc, b)
    assert torch.equal(first, k12.ct2x2_int8(x, wk, sc, b))


def test_k2_extremes(dev):
    """+-127 inputs and weights at ct0 (|acc| up to 512 * 127^2 =
    8,258,048, exact in float32), bit for bit."""
    rng = np.random.default_rng(32)
    x = torch.tensor(rng.choice([-127, 127], (2, 32, 32, 512)),
                     dtype=torch.int8, device=dev)
    wq = torch.tensor(rng.choice([-127, 127], (512, 256, 2, 2)),
                      dtype=torch.int8, device=dev)
    wq[:, 0] = 127  # column 0 of every tap: |acc| = 512 * 127^2 at x = +-127
    x[0, 0, 0] = 127
    wk = k12.pack_ct2x2_weights(wq)
    sc = _vec(rng, 256, 1e-5, 2e-5, dev)
    b = _vec(rng, 256, -5, 5, dev)
    got = k12.ct2x2_int8(x, wk, sc, b)
    torch.cuda.synchronize()
    assert torch.equal(got, k12.ct2x2_int8_reference(x, wk, sc, b))
    assert int(got.abs().max()) == 127


def test_k2_refuses_what_it_cannot_take(dev):
    """Weights of the old layout or the wrong width, a clip that is not an
    integer, and cin too deep for the block's shared memory raise; nothing
    is launched."""
    rng = np.random.default_rng(33)
    x, wk, sc, b, _ = _k2_args(rng, dev, 1, 4, 4, 64, 32, "int8")
    before = k12.ct2x2_int8.launches
    with pytest.raises(ValueError, match="weights"):
        k12.ct2x2_int8(x, wk.reshape(16, 128, 4), sc, b)
    with pytest.raises(ValueError, match="weights"):
        k12.ct2x2_int8(x, wk[:, :64].contiguous(), sc, b)
    with pytest.raises(ValueError, match="out_clip"):
        k12.ct2x2_int8(x, wk, sc, b, out_clip=7.5)
    deep = _i8(rng, (1, 2, 2, 4096), dev)
    wd = k12.pack_ct2x2_weights(_i8(rng, (4096, 8, 2, 2), dev))
    with pytest.raises(ValueError, match="no launch"):
        k12.ct2x2_int8(deep, wd, sc[:8].contiguous(), b[:8].contiguous())
    assert k12.ct2x2_int8.launches == before


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


def _k3_args(rng, shape, cin, nc, ties, dev):
    x, w, sc, b = k3_case(rng, int(np.prod(shape)), cin, nc, ties)
    return (torch.tensor(x, device=dev).reshape(shape + (cin,)),
            torch.tensor(w, device=dev), torch.tensor(sc, device=dev),
            torch.tensor(b, device=dev))


# the served heads at batch 2: the U-Net's at f=32 (PSRP and packed
# graphs), ReLayNet's at f=64, the U-Net's at f=16
@pytest.mark.parametrize("cin", [32, 64, 16])
def test_k3_serving_heads_match_plain_and_repeat(dev, cin):
    rng = np.random.default_rng(cin)
    args = _k3_args(rng, (2, 512, 512), cin, 10, False, dev)
    before = k3.head_argmax.launches
    got = k3.head_argmax(*args)
    again = k3.head_argmax(*args)
    torch.cuda.synchronize()
    assert k3.head_argmax.launches == before + 2
    assert got.shape == (2, 512, 512) and got.dtype == torch.int8
    assert torch.equal(got, k3.head_argmax_reference(*args))
    assert torch.equal(again, got)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nc", [1, 8, 10, 17, 32])
@pytest.mark.parametrize("cin", [4, 12, 32, 48, 64])
def test_k3_classes_channels_and_ties(dev, cin, nc, ties):
    """Every copy path and instance, ragged P (1073 pixels: a tile of 49),
    ties across n8 tiles, across a quad's lanes and of all classes."""
    rng = np.random.default_rng(cin * 100 + nc)
    args = _k3_args(rng, (1, 37, 29), cin, nc, ties, dev)
    got = k3.head_argmax(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, k3.head_argmax_reference(*args))
    if ties:
        assert bool((got.reshape(-1)[:40] == 0).all())


def test_k3_rejects_misaligned_input(dev):
    rng = np.random.default_rng(3)
    x, w, sc, b = _k3_args(rng, (1, 4, 4), 32, 10, False, dev)
    odd = torch.empty(x.numel() + 4, dtype=torch.int8, device=dev)[4:]
    before = k3.head_argmax.launches
    with pytest.raises(ValueError, match="16-byte"):
        k3.head_argmax(odd.view(x.shape), w, sc, b)
    assert k3.head_argmax.launches == before


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


def _bf16(rng, shape, dev, integers=True):
    v = rng.integers(-2, 3, shape) if integers else rng.standard_normal(shape)
    return torch.tensor(v, dtype=torch.bfloat16, device=dev)


def _bf16_ulp(t):
    """bf16 ulp of each element's magnitude (float32)."""
    t = torch.clamp_min(t.float().abs(), 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(t)) - 7)


CONV_SHAPES = [
    (2, 16, 16, 32, 32),   # 512^2-stage widths, vector loads
    (1, 7, 9, 5, 3),       # odd channels (scalar loads), partial tiles
    (2, 10, 20, 24, 40),   # cout not a multiple of 32
    (1, 8, 16, 64, 96),    # several channel chunks and cout tiles
    # K5's ring and tiles (ops/conv_bf16.py:wgrad_plan)
    (1, 70, 24, 32, 32),   # bands of 8 rows, the last one of 6
    (2, 9, 200, 16, 32),   # column tiles of 128, the last one of 72
    (1, 10, 160, 64, 32),  # cin 64 -> cout 32 wider than a column tile
    # K4's mma.sync body (ops/conv_bf16.py:fwd_plan): partial 32 x 16
    # tiles at 32 and 64 outputs (two channel tiles)
    (1, 40, 48, 64, 32),
    (1, 40, 48, 32, 64),
]


@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_k4_k5_bit_equal_on_integers(dev, n, h, w, cin, cout):
    rng = np.random.default_rng(4)
    x = _bf16(rng, (n, h, w, cin), dev)
    wt = _bf16(rng, (3, 3, cin, cout), dev)
    dy = _bf16(rng, (n, h, w, cout), dev)
    before = (k45.conv3x3_bf16_fwd.launches, k45.conv3x3_bf16_wgrad.launches)
    y = k45.conv3x3_bf16_fwd(x, wt)
    dx = k45.conv3x3_bf16_fwd(dy, k45.flip_w(wt))
    dw = k45.conv3x3_bf16_wgrad(x, dy)
    torch.cuda.synchronize()
    assert (k45.conv3x3_bf16_fwd.launches, k45.conv3x3_bf16_wgrad.launches) \
        == (before[0] + 2, before[1] + 1)
    assert torch.equal(y, k45.conv3x3_bf16_reference(x, wt))
    assert torch.equal(dx, k45.conv3x3_bf16_dgrad_reference(dy, wt))
    assert torch.equal(dw, k45.conv3x3_bf16_wgrad_reference(x, dy))


@pytest.mark.parametrize("n,h,w,cin,cout", CONV_SHAPES)
def test_k4_k5_on_random_data(dev, n, h, w, cin, cout):
    """fp32 sums in another order, on the tensor cores: K4 within one bf16
    ulp of the float64 plain version plus 2^-16 of the sum of |products|
    (where a sum cancels, the tensor cores' fp32 accumulation error is many
    ulps of the result); K5 within 1e-5 of its largest element."""
    rng = np.random.default_rng(5)
    x = _bf16(rng, (n, h, w, cin), dev, integers=False)
    wt = _bf16(rng, (3, 3, cin, cout), dev, integers=False)
    dy = _bf16(rng, (n, h, w, cout), dev, integers=False)
    want = k45.conv3x3_bf16_reference(x, wt).float()
    mag = k45.conv3x3_bf16_reference(x.abs(), wt.abs()).float()
    err = (k45.conv3x3_bf16_fwd(x, wt).float() - want).abs()
    assert bool((err <= _bf16_ulp(want) + 2.0 ** -16 * mag).all())
    got = k45.conv3x3_bf16_wgrad(x, dy)
    want = k45.conv3x3_bf16_wgrad_reference(x, dy)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 64, 48, 32, 32),
                                             (1, 40, 48, 32, 64)])
def test_k4_repeats_bit_for_bit(dev, n, h, w, cin, cout):
    """K4's mma.sync body sums without atomics: two calls on the same
    random inputs give the same bits."""
    assert k45.fwd_plan(n, h, w, cin, cout).body == "mma"
    rng = np.random.default_rng(7)
    x = _bf16(rng, (n, h, w, cin), dev, integers=False)
    wt = _bf16(rng, (3, 3, cin, cout), dev, integers=False)
    first = k45.conv3x3_bf16_fwd(x, wt)
    second = k45.conv3x3_bf16_fwd(x, wt)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_conv3x3_bf16_autograd_launches(dev):
    rng = np.random.default_rng(6)
    x = _bf16(rng, (2, 8, 16, 16), dev).requires_grad_()
    wt = _bf16(rng, (3, 3, 16, 32), dev).requires_grad_()
    f0, g0 = k45.conv3x3_bf16_fwd.launches, k45.conv3x3_bf16_wgrad.launches
    y = k45.conv3x3_bf16(x, wt)
    dy = _bf16(rng, y.shape, dev)
    gx, gw = torch.autograd.grad(y, (x, wt), dy)
    torch.cuda.synchronize()
    assert k45.conv3x3_bf16_fwd.launches == f0 + 2
    assert k45.conv3x3_bf16_wgrad.launches == g0 + 1
    xc, wc, dc = x.detach().cpu(), wt.detach().cpu(), dy.cpu()
    assert torch.equal(gx.cpu(), k45.conv3x3_bf16_dgrad_reference(dc, wc))
    assert torch.equal(gw.cpu(),
                       k45.conv3x3_bf16_wgrad_reference(xc, dc).bfloat16())


@pytest.mark.parametrize("shape", [(2, 16, 16, 32), (3, 8, 8, 512), (6, 5),
                                   (4, 33, 130),
                                   # SDNet's: the gate's psi (C=1), the
                                   # encoder's dense BN (M=4), its 16-wide
                                   # convs
                                   (2, 16, 16, 1), (4, 32), (2, 32, 32, 16)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("two", [False, True])
def test_k6_matches_float64(dev, shape, dtype, two):
    """K6 within rtol 1e-6 of the float64 sums on N(1, 1) inputs (positive
    means, so no sum cancels)."""
    rng = np.random.default_rng(7)
    a = torch.tensor(rng.normal(1, 1, shape), dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(1, 1, shape), dtype=dtype, device=dev) \
        if two else None
    before = k6.pair_sums.launches
    got = k6.pair_sums(a, b)
    torch.cuda.synchronize()
    assert k6.pair_sums.launches == before + 1
    want = k6.pair_sums_reference(a, b)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", K6_ORDER_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("two", [False, True])
def test_k6_matches_its_emulation(dev, shape, dtype, two):
    """K6 bit for bit equal to the numpy emulation of its order of
    additions on the plan it launched (``tests/test_torch_k6_order.py``),
    and a second call on the same inputs bit-identical."""
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.normal(1, 1, shape), dtype=dtype, device=dev)
    b = torch.tensor(rng.normal(1, 1, shape), dtype=dtype, device=dev) \
        if two else None
    plan = k6.launch_plan(a, b)
    first, second = k6.pair_sums(a, b), k6.pair_sums(a, b)
    torch.cuda.synchronize()
    want = k6_emulate(a.float().cpu().numpy(),
                      None if b is None else b.float().cpu().numpy(), plan)
    assert torch.equal(first, second)
    assert np.array_equal(first.cpu().numpy(), want), plan.text()


def test_k6_calls_back_to_back(dev):
    """Calls of other (M, C), modes and dtypes back to back on one stream,
    with no synchronisation between them, each equal to the same call made
    alone: nothing carries over from one call to the next."""
    rng = np.random.default_rng(10)
    calls = []
    for shape, dtype, two in (((8, 64, 64, 32), torch.bfloat16, True),
                              ((3, 5), torch.float32, False),
                              ((4, 33, 130), torch.bfloat16, False),
                              ((2, 32, 32, 512), torch.bfloat16, True),
                              ((2, 16, 16, 1), torch.float32, True),
                              ((8, 64, 64, 32), torch.bfloat16, False)):
        a = torch.tensor(rng.normal(1, 1, shape), dtype=dtype, device=dev)
        b = torch.tensor(rng.normal(1, 1, shape), dtype=dtype,
                         device=dev) if two else None
        calls.append((a, b))
    alone = []
    for a, b in calls:
        alone.append(k6.pair_sums(a, b))
        torch.cuda.synchronize()
    together = [k6.pair_sums(a, b) for a, b in calls]
    torch.cuda.synchronize()
    for got, want in zip(together, alone):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bn_train_cuda_matches_cpu(dev, dtype):
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(0.5, 2, (2, 8, 10, 32)), dtype=dtype)
    g = torch.tensor(rng.uniform(0.5, 1.5, 32), dtype=torch.float32)
    b = torch.tensor(rng.normal(0, 1, 32), dtype=torch.float32)
    r = torch.tensor(rng.normal(0, 1, x.shape), dtype=dtype)
    outs = []
    for d in ("cpu", dev):
        xs, gs, bs = (t.to(d).requires_grad_() for t in (x, g, b))
        y, mean, var = k6.bn_train(xs, gs, bs)
        grads = torch.autograd.grad(y, (xs, gs, bs), r.to(d))
        outs.append([t.float().cpu() for t in (y, mean, var, *grads)])
    atol = 1e-5 if dtype == torch.float32 else 0.05
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("n,h,w,cins,cout,kh,pool", [
    (2, 16, 16, (1,), 64, 7, True),         # the stem, Cin=1
    (1, 6, 10, (5,), 3, 7, False),          # odd channels, partial tile
    (2, 34, 18, (64,), 64, 7, True),        # several tiles, pool
    (1, 20, 36, (64, 64), 64, 7, False),    # the decoders' two inputs
    (1, 12, 8, (8, 4), 40, 5, True),        # kh 5, cout % 32 != 0
    (1, 7, 9, (32,), 32, 3, False),         # kh 3, odd H, W
    (1, 40, 72, (64, 64), 64, 7, False),    # b6-like, partial tiles
])
def test_k7_matches_plain(dev, n, h, w, cins, cout, kh, pool):
    rng = np.random.default_rng(9)
    xs = tuple(_i8(rng, (n, h, w, c), dev) for c in cins)
    wk = k7.pack_conv7x3_weights(_i8(rng, (cout, sum(cins), kh, 3), dev,
                                     -40, 40))
    std = (kh * 3 * sum(cins)) ** 0.5 * 73 * 23
    sc, b = _vec(rng, cout, 30 / std, 60 / std, dev), _vec(rng, cout, -5, 5,
                                                          dev)
    before = k7.conv7x3_int8.launches
    got = k7.conv7x3_int8(xs, wk, sc, b, 0.21, pool=pool)
    want = k7.conv7x3_int8_reference(xs, wk, sc, b, 0.21, pool=pool)
    torch.cuda.synchronize()
    assert k7.conv7x3_int8.launches == before + 1
    got, want = (got, want) if pool else ((got,), (want,))
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert bool((got[0] < -10).any() and (got[0] > 10).any())


def _k7_both(xs, wk, sc, b, alpha, pool):
    got = k7.conv7x3_int8(xs, wk, sc, b, alpha, pool=pool)
    want = k7.conv7x3_int8_reference(xs, wk, sc, b, alpha, pool=pool)
    torch.cuda.synchronize()
    return (got, want) if pool else ((got,), (want,))


@pytest.mark.parametrize("h,cins", [(32, (1,)), (34, (64,)), (20, (64, 64))])
def test_k7_pool_ties_take_index_0(dev, h, cins):
    """Constant input and zero weights: every 2x2 window ties (the value is
    the bias), so every pooled index is 0, as the strict > order says."""
    rng = np.random.default_rng(11)
    xs = tuple(torch.full((2, h, h + 2, c), 5, dtype=torch.int8, device=dev)
               for c in cins)
    wk = k7.pack_conv7x3_weights(torch.zeros((64, sum(cins), 7, 3),
                                             dtype=torch.int8, device=dev))
    sc, b = _vec(rng, 64, 0.5, 1.0, dev), _vec(rng, 64, -100, 100, dev)
    got, want = _k7_both(xs, wk, sc, b, 0.21, True)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert not bool(got[2].any())
    assert bool((got[1] < -10).any() and (got[1] > 10).any())


def test_k7_extreme_values(dev):
    """All inputs and weights at +-127, cin 128: |acc| reaches 21 * 128 *
    127^2 = 43,354,368 in the interior; outputs match the plain version."""
    rng = np.random.default_rng(12)
    xs = tuple(torch.full((2, 40, 36, 64), 127, dtype=torch.int8, device=dev)
               for _ in range(2))
    xs[1][:, :10] = -127  # rows 13.. see all +127: |acc| = 43,354,368
    sign = torch.tensor(rng.choice([-1, 1], (64, 128, 7, 3)), device=dev)
    sign[0::3] = 1
    sign[1::3] = -1
    wk = k7.pack_conv7x3_weights((127 * sign).to(torch.int8))
    sc = _vec(rng, 64, 100 / 43354368, 200 / 43354368, dev)
    b = _vec(rng, 64, -5, 5, dev)
    got, want = _k7_both(xs, wk, sc, b, 0.5, True)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert bool((got[0] == 127).any() and (got[0] < -40).any())


@pytest.mark.parametrize("h,cins,pool", [(64, (1,), True),
                                         (48, (64, 64), False)])
def test_k7_repeats_bit_for_bit(dev, h, cins, pool):
    rng = np.random.default_rng(13)
    xs = tuple(_i8(rng, (2, h, h, c), dev) for c in cins)
    wk = k7.pack_conv7x3_weights(_i8(rng, (64, sum(cins), 7, 3), dev))
    std = (21 * sum(cins)) ** 0.5 * 73 * 73
    sc, b = _vec(rng, 64, 30 / std, 60 / std, dev), _vec(rng, 64, -5, 5, dev)
    first = k7.conv7x3_int8(xs, wk, sc, b, 0.3, pool=pool)
    second = k7.conv7x3_int8(xs, wk, sc, b, 0.3, pool=pool)
    torch.cuda.synchronize()
    first, second = (first, second) if pool else ((first,), (second,))
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_relaynet_graph_kernels_match_plain(dev):
    model = build_model("relaynet", num_classes=5, init_features=8, seed=0,
                        device=dev)
    forward, calib = build_relaynet_psrp_forward(model, image_size=64,
                                                 device=dev)
    x = preprocess(torch.tensor(
        np.random.default_rng(3).uniform(0, 255, (3, 64, 64, 1)),
        dtype=torch.float32, device=dev,
    ))
    before = k7.conv7x3_int8.launches, k3.head_argmax.launches
    with torch.inference_mode():
        got = relaynet_psrp_forward(calib["qparams"], x, 5)
        want = relaynet_psrp_forward(calib["qparams"], x, 5, reference=True)
    assert (k7.conv7x3_int8.launches, k3.head_argmax.launches) == \
        (before[0] + 7, before[1] + 1)
    assert got.shape == (3, 64, 64) and got.dtype == torch.int8
    assert torch.equal(got, want)


def _dice_ce_case(rng, shape, nc, dtype, label_dtype, dev):
    x = torch.tensor(rng.standard_normal(shape + (nc,)) * 3, dtype=dtype,
                     device=dev)
    lab = rng.integers(0, nc, shape)
    lab.flat[::97] = nc  # labels outside the classes count for nothing
    return x, torch.tensor(lab, dtype=label_dtype, device=dev)


DICE_CE_SHAPES = [
    ((2, 7, 9), 5, torch.float32, torch.int64),
    ((1, 33, 17), 10, torch.bfloat16, torch.int32),
    ((3, 64, 40), 32, torch.bfloat16, torch.int64),
    ((1, 1, 1), 1, torch.float32, torch.int32),
]


@pytest.mark.parametrize("shape,nc,dtype,label_dtype", DICE_CE_SHAPES)
def test_k8_k9_match_float64(dev, shape, nc, dtype, label_dtype):
    """K8 within rtol 1e-5 of the float64 sums (no sum cancels); K9 within
    one ulp of the logits' dtype of the float64 dlogits, plus an fp32 floor
    of 2^-20 of the largest (the fp32 sum of dlogit's terms, each up to the
    largest, can cancel; where p_label is within ~1e-5 of 1, p - 1 does)."""
    rng = np.random.default_rng(10)
    x, lab = _dice_ce_case(rng, shape, nc, dtype, label_dtype, dev)
    cw = torch.tensor(rng.uniform(0.5, 2.0, nc), dtype=torch.float32,
                      device=dev)
    coef = torch.tensor(rng.normal(0, 1e-3, 3 * nc), dtype=torch.float32,
                        device=dev)
    before = k89.dice_ce_stats.launches, k89.dice_ce_bwd.launches
    stats = k89.dice_ce_stats(x, lab, cw)
    dx = k89.dice_ce_bwd(x, lab, coef)
    torch.cuda.synchronize()
    assert (k89.dice_ce_stats.launches, k89.dice_ce_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(stats, k89.dice_ce_stats_reference(x, lab, cw),
                               rtol=1e-5, atol=1e-6)
    assert dx.dtype == dtype and dx.shape == x.shape
    _assert_k9_within_ulp(dx, x, lab, coef)


def _assert_k9_within_ulp(dx, x, lab, coef):
    """dx within one ulp of x's dtype of the float64 dlogits, plus the
    fp32 floor (see test_k8_k9_match_float64)."""
    want = k89.dice_ce_bwd_reference(x, lab, coef)
    exact = k89.dice_ce_bwd_reference(x.double(), lab, coef)
    err = (dx.double() - exact).abs()
    ulp = (_bf16_ulp(want) if x.dtype == torch.bfloat16
           else want.float().abs().clamp_min(2.0 ** -126) * 2.0 ** -23)
    floor = 2.0 ** -20 * float(exact.abs().max())
    assert bool((err <= ulp.double() + floor).all())


@pytest.mark.parametrize("shape,nc,dtype,label_dtype", [
    ((8, 64, 64), 10, torch.bfloat16, torch.int64),  # the train step's C
    ((1, 37, 29), 10, torch.bfloat16, torch.int32),  # a ragged tile
    ((2, 33, 17), 5, torch.bfloat16, torch.int64),   # 10-byte pixels
    ((1, 40, 40), 32, torch.float32, torch.int64),
    ((3, 7, 11), 16, torch.float32, torch.int32),
    ((1, 1, 1), 1, torch.bfloat16, torch.int32),
])
def test_k9_tiles_within_ulp_and_repeat(dev, shape, nc, dtype, label_dtype):
    """K9's tiled body within one ulp of the float64 dlogits, and a second
    call bit-identical to the first."""
    rng = np.random.default_rng(12)
    x, lab = _dice_ce_case(rng, shape, nc, dtype, label_dtype, dev)
    coef = torch.tensor(rng.normal(0, 1e-3, 3 * nc), dtype=torch.float32,
                        device=dev)
    dx = k89.dice_ce_bwd(x, lab, coef)
    again = k89.dice_ce_bwd(x, lab, coef)
    torch.cuda.synchronize()
    _assert_k9_within_ulp(dx, x, lab, coef)
    assert torch.equal(again, dx)


def test_k9_rejects_misaligned_inputs(dev):
    rng = np.random.default_rng(13)
    x, lab = _dice_ce_case(rng, (1, 8, 8), 10, torch.bfloat16, torch.int64,
                           dev)
    coef = torch.zeros(30, device=dev)
    odd = torch.empty(x.numel() + 1, dtype=x.dtype, device=dev)[1:]
    odd_lab = torch.empty(lab.numel() + 1, dtype=lab.dtype, device=dev)[1:]
    before = k89.dice_ce_bwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        k89.dice_ce_bwd(odd.view(x.shape), lab, coef)
    with pytest.raises(ValueError, match="16-byte"):
        k89.dice_ce_bwd(x, odd_lab.view(lab.shape), coef)
    assert k89.dice_ce_bwd.launches == before


def test_fused_loss_autograd_on_the_card(dev):
    """``dice_ce_loss_fused`` on CUDA tensors launches K8 once forward and
    K9 once backward, and matches the unfused loss on the card."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.losses import (
        dice_ce_loss,
    )

    rng = np.random.default_rng(11)
    x, lab = _dice_ce_case(rng, (2, 32, 48), 10, torch.float32,
                           torch.int64, dev)
    lab = lab.clamp_max(9)
    before = k89.dice_ce_stats.launches, k89.dice_ce_bwd.launches
    out = []
    for fn in (k89.dice_ce_loss_fused, dice_ce_loss):
        xs = x.clone().requires_grad_()
        loss = fn(xs, lab, [1.0] * 5 + [2.0] * 5, 0.5)
        (g,) = torch.autograd.grad(loss, xs)
        out.append((float(loss), g))
    torch.cuda.synchronize()
    assert (k89.dice_ce_stats.launches, k89.dice_ce_bwd.launches) == \
        (before[0] + 1, before[1] + 1)
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    torch.testing.assert_close(out[0][1], out[1][1], rtol=1e-4, atol=1e-8)
    with pytest.raises(ValueError, match="33 classes"):
        k89.dice_ce_loss_fused(torch.zeros((1, 2, 2, 33), device=dev),
                               torch.zeros((1, 2, 2), dtype=torch.int64,
                                           device=dev))


@pytest.mark.parametrize("n,h,w,c1,cout", [
    (2, 64, 64, 32, 32),   # the f=32 stem's widths
    (2, 80, 48, 16, 16),   # f=16, non-square, an odd number of tiles
    (1, 20, 14, 3, 40),    # c1 <= 4 (one word), partial tiles, cout % 32
])
def test_k10_matches_plain(dev, n, h, w, c1, cout):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    rng = np.random.default_rng(12)
    x = _i8(rng, (n, h, w, 1), dev)
    w0 = k12.pack_conv3x3_weights(_i8(rng, (c1, 1, 3, 3), dev, -40, 40))
    w1 = k12.pack_conv3x3_weights(_i8(rng, (cout, c1, 3, 3), dev, -40, 40))
    # a stem bias high enough that relu(round(bias0)) != 0: a halo that
    # held the stem of a zero-padded image would show at the border
    s0, b0 = _vec(rng, c1, 0.05, 0.1, dev), _vec(rng, c1, 10, 40, dev)
    s1, b1 = _vec(rng, cout, 1e-3, 3e-3, dev), _vec(rng, cout, -5, 5, dev)
    before = k10.stem_conv_int8.launches
    got = k10.stem_conv_int8(x, w0, s0, b0, w1, s1, b1)
    want = k10.stem_conv_int8_reference(x, w0, s0, b0, w1, s1, b1)
    torch.cuda.synchronize()
    assert k10.stem_conv_int8.launches == before + 1
    assert got[0].shape == (n, h, w, cout)
    assert got[1].shape == (n, h // 2, w // 2, cout)
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert int(got[0].max()) > 0 and int(got[0].min()) == 0


def test_k10_rejects_bad_input(dev):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    z = torch.zeros
    x = z((1, 8, 8, 1), dtype=torch.int8, device=dev)
    w0 = k12.pack_conv3x3_weights(z((64, 1, 3, 3), dtype=torch.int8,
                                    device=dev))
    w1 = k12.pack_conv3x3_weights(z((8, 64, 3, 3), dtype=torch.int8,
                                    device=dev))
    one = torch.ones(64, device=dev)
    with pytest.raises(ValueError, match="c1 64"):
        k10.stem_conv_int8(x, w0, one, one, w1, one[:8], one[:8])
    with pytest.raises(ValueError, match="even"):
        k10.stem_conv_int8(x[:, :7], w0, one, one, w1, one[:8], one[:8])


@pytest.mark.parametrize("shape", [
    (2, 16, 12, 32),     # the CPU test's shape, 16-byte vectors
    (2, 32, 32, 128),    # a deep pool's widths
    (3, 10, 14, 24),     # C = 24: 8-byte vectors
    (1, 6, 4, 12),       # 4-byte words
    (2, 8, 6, 3),        # single bytes
])
def test_k11_matches_plain(dev, shape):
    rng = np.random.default_rng(13)
    x = _i8(rng, shape, dev, -128, 128)
    before = k12.pool2x2_int8.launches
    got = k12.pool2x2_int8(x)
    torch.cuda.synchronize()
    assert k12.pool2x2_int8.launches == before + 1
    assert torch.equal(got, k12.pool2x2_int8_reference(x))


def test_k11_rejects_bad_input(dev):
    x = torch.zeros((1, 6, 5, 16), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="even"):
        k12.pool2x2_int8(x)
    with pytest.raises(ValueError, match="contiguous"):
        k12.pool2x2_int8(x[:, :, :4].transpose(1, 2))


def test_psrp_graph_stem_fuse_on_the_card(dev):
    """The fused stem (K10) gives the same labels as K1's stem and
    blk0_conv1, and the forward launches K10 once and K1 16 times."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    model = build_model(num_classes=5, init_features=16, seed=0, device=dev)
    _, calib = build_psrp_forward(model, image_size=64, device=dev)
    x = preprocess(torch.tensor(
        np.random.default_rng(14).uniform(0, 255, (2, 64, 64, 1)),
        dtype=torch.float32, device=dev))
    with torch.inference_mode():
        want = unet_psrp_forward(calib["qparams"], x, 5, stem_fuse=False)
        before = k10.stem_conv_int8.launches, k12.conv3x3_int8.launches
        got = unet_psrp_forward(calib["qparams"], x, 5, stem_fuse=True)
        plain = unet_psrp_forward(calib["qparams"], x, 5, stem_fuse=True,
                                  reference=True)
    torch.cuda.synchronize()
    assert (k10.stem_conv_int8.launches - before[0],
            k12.conv3x3_int8.launches - before[1]) == (1, 16)
    assert torch.equal(got, want) and torch.equal(got, plain)


def test_packed_graph_kernels_match_plain(dev):
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli import (
        build_quantized_forward,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.packed import (
        LAUNCHES_PER_FORWARD,
        unet_packed_forward,
    )

    model = build_model(num_classes=5, init_features=32, seed=0, device=dev)
    _, calib = build_quantized_forward(model, "unet", "packed",
                                       image_size=64, device=dev)
    x = preprocess(torch.tensor(
        np.random.default_rng(15).uniform(0, 255, (2, 64, 64, 1)),
        dtype=torch.float32, device=dev))
    wrappers = {"conv3x3_int8": k12.conv3x3_int8,
                "pool2x2_int8": k12.pool2x2_int8,
                "ct2x2_int8": k12.ct2x2_int8, "head_argmax": k3.head_argmax}
    before = {k: w.launches for k, w in wrappers.items()}
    with torch.inference_mode():
        got = unet_packed_forward(calib["qparams"], x, 5)
        torch.cuda.synchronize()
        launched = {k: w.launches - before[k] for k, w in wrappers.items()}
        want = unet_packed_forward(calib["qparams"], x, 5, reference=True)
    assert launched == LAUNCHES_PER_FORWARD
    assert got.shape == (2, 64, 64) and torch.equal(got, want)


@pytest.mark.parametrize("shape", [(2, 8, 10, 1), (4, 32), (8, 32)])
def test_bn_train_cuda_sdnet_shapes(dev, shape):
    """``bn_train`` at SDNet's BN shapes K6 had not seen: one channel, and
    a few rows of dense features."""
    rng = np.random.default_rng(16)
    c = shape[-1]
    x = torch.tensor(rng.normal(0.5, 2, shape), dtype=torch.float32)
    g = torch.tensor(rng.uniform(0.5, 1.5, c), dtype=torch.float32)
    b = torch.tensor(rng.normal(0, 1, c), dtype=torch.float32)
    r = torch.tensor(rng.normal(0, 1, shape), dtype=torch.float32)
    outs = []
    for d in ("cpu", dev):
        xs, gs, bs = (t.to(d).requires_grad_() for t in (x, g, b))
        y, mean, var = k6.bn_train(xs, gs, bs)
        grads = torch.autograd.grad(y, (xs, gs, bs), r.to(d))
        outs.append([t.float().cpu() for t in (y, mean, var, *grads)])
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


# K12: (B, L, H, W); odd H and W, L = 11 (the curvature table), full size
K12_SHAPES = [(2, 5, 100, 200), (2, 11, 64, 48), (1, 3, 7, 33),
              (8, 3, 512, 512)]


@pytest.mark.parametrize("shape", K12_SHAPES)
def test_k12_matches_plain(dev, shape):
    """sm within 1e-6, pos and std within 1e-5 * H of the plain version."""
    x = torch.tensor(np.random.default_rng(17).standard_normal(shape) * 3,
                     dtype=torch.float32, device=dev)
    before = k12sm.column_softargmax_forward.launches
    got = k12sm.column_softargmax_forward(x)
    torch.cuda.synchronize()
    assert k12sm.column_softargmax_forward.launches == before + 1
    want = k12sm.column_softargmax_reference(x)
    H = shape[2]
    for g, w, tol in zip(got, want, (1e-6, 1e-5 * H, 1e-5 * H)):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("shape", K12_SHAPES[:2])
def test_k12_backward_matches_plain_autograd(dev, shape):
    """dx from random cotangents of (sm, pos, std) against autograd through
    the plain version, within 1e-5 of the largest |dx|."""
    rng = np.random.default_rng(18)
    x = torch.tensor(rng.standard_normal(shape) * 2, dtype=torch.float32,
                     device=dev)
    B, L, H, W = shape
    cot = [torch.tensor(rng.standard_normal(s), dtype=torch.float32,
                        device=dev) for s in (shape, (B, L, W), (B, L, W))]
    grads = []
    for fn in (k12sm.column_softargmax, k12sm.column_softargmax_reference):
        xs = x.clone().requires_grad_(True)
        outs = fn(xs)
        sum(torch.sum(o * c) for o, c in zip(outs, cot)).backward()
        grads.append(xs.grad)
    err = float((grads[0] - grads[1]).abs().max())
    assert err <= 1e-5 * float(grads[1].abs().max())


def test_k12_one_hot_column_without_std_cotangent(dev):
    x = torch.tensor(np.random.default_rng(19).standard_normal((1, 2, 24, 40)),
                     dtype=torch.float32, device=dev)
    x[0, 1, 7, 3] = 1e4
    xs = x.requires_grad_(True)
    sm, pos, std = k12sm.column_softargmax(xs)
    assert float(std[0, 1, 3].detach()) == 0.0
    (torch.sum(sm * torch.linspace(-1, 1, 24, device=dev).view(1, 1, 24, 1))
     + torch.sum(pos)).backward()
    assert bool(torch.isfinite(xs.grad).all())


def test_k12_rejects_bad_input(dev):
    with pytest.raises(ValueError, match="float32"):
        k12sm.column_softargmax_forward(
            torch.zeros(1, 1, 4, 4, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="B, L, H, W"):
        k12sm.column_softargmax_forward(torch.zeros(1, 4, 4, device=dev))


def test_sdnet_forward_kernel_matches_plain(dev):
    """A small SDNet on the card: K12 once per forward, and the forward
    with the plain version swapped in agrees (masks 1e-5, positions
    1e-5 * H)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.registry import (
        get_model,
    )

    model = get_model("sdnet", num_classes=4, img_size=64,
                      channels=(8, 16, 32, 64, 128)).to(dev)
    x = torch.tensor(np.random.default_rng(20).standard_normal(
        (2, 1, 64, 64)), dtype=torch.float32, device=dev)
    eps = torch.zeros(2, 15, device=dev)
    with torch.no_grad():
        before = k12sm.column_softargmax_forward.launches
        got = model(x, eps=eps)
        torch.cuda.synchronize()
        assert k12sm.column_softargmax_forward.launches == before + 1
        kernel = k12sm.column_softargmax
        k12sm.column_softargmax = k12sm.column_softargmax_reference
        try:
            want = model(x, eps=eps)
        finally:
            k12sm.column_softargmax = kernel
    assert float((got["clean_masks"] - want["clean_masks"]).abs().max()) \
        <= 1e-5
    assert float((got["layer_positions"] - want["layer_positions"]).abs()
                 .max()) <= 1e-5 * 64


# the w4a4 knobs of K1 and K2, and K1's fused head


@pytest.mark.parametrize("n,h,w,cins,cout,knobs", [
    (2, 16, 16, (16,), 16, dict(pad_vals=(-7,), relu=False, out_clip=7.0)),
    (1, 8, 16, (64, 64), 64, dict(pad_vals=(0, -7), relu=False,
                                 out_clip=7.0)),
    (1, 7, 9, (5, 3), 8, dict(pad_vals=(-7, 3))),   # byte loads, odd H, W
    (2, 16, 16, (8,), 8, dict(pool=True, pool_rescale=14 / 127,
                             pool_shift=-7.0, pool_clip=7.0)),
    (1, 34, 18, (32,), 64, dict(pool=True, relu=False, out_clip=7.0)),
])
def test_k1_w4a4_knobs_match_plain(dev, n, h, w, cins, cout, knobs):
    rng = np.random.default_rng(20)
    xs = tuple(_i8(rng, (n, h, w, c), dev, -7, 8) for c in cins)
    wk = k12.pack_conv3x3_weights(_i8(rng, (cout, sum(cins), 3, 3), dev,
                                      -7, 8))
    sc, b = _vec(rng, cout, 0.01, 0.05, dev), _vec(rng, cout, -5, 5, dev)
    got = k12.conv3x3_int8(xs, wk, sc, b, **knobs)
    want = k12.conv3x3_int8_reference(xs, wk, sc, b, **knobs)
    torch.cuda.synchronize()
    for g_, w_ in zip(got if knobs.get("pool") else (got,),
                      want if knobs.get("pool") else (want,)):
        assert torch.equal(g_, w_)


@pytest.mark.parametrize("n,h,w,cin,cout,nc", [
    (2, 16, 16, 32, 32, 10), (1, 7, 21, 8, 12, 5), (1, 16, 16, 36, 4, 32),
])
def test_k1_fused_head_matches_plain(dev, n, h, w, cin, cout, nc):
    rng = np.random.default_rng(21)
    x = _i8(rng, (n, h, w, cin), dev)
    wk = k12.pack_conv3x3_weights(_i8(rng, (cout, cin, 3, 3), dev, -40, 40))
    sc, b = _vec(rng, cout, 1e-4, 3e-4, dev), _vec(rng, cout, -5, 5, dev)
    head = (k3.pack_head_weights(_i8(rng, (nc, cout, 1, 1), dev, -40, 40)),
            _vec(rng, nc, 1e-3, 2e-3, dev), _vec(rng, nc, -1, 1, dev))
    before = k12.conv3x3_int8.launches
    got = k12.conv3x3_int8(x, wk, sc, b, head=head)
    torch.cuda.synchronize()
    assert k12.conv3x3_int8.launches == before + 1
    assert got.shape == (n, h, w) and got.dtype == torch.int8
    assert torch.equal(got, k12.conv3x3_int8_reference(x, wk, sc, b,
                                                       head=head))
    assert torch.equal(got, k3.head_argmax_reference(
        k12.conv3x3_int8(x, wk, sc, b), *head))
    with pytest.raises(ValueError, match="head"):
        k12.conv3x3_int8(x, wk, sc, b, head=head, pool=True)


def test_k2_per_column_bias_matches_plain(dev):
    rng = np.random.default_rng(22)
    x = _i8(rng, (2, 8, 8, 128), dev, -7, 8)
    wk = k12.pack_ct2x2_weights(_i8(rng, (128, 64, 2, 2), dev, -7, 8))
    sc, b = _vec(rng, 64, 0.01, 0.03, dev), _vec(rng, 256, -5, 5, dev)
    got = k12.ct2x2_int8(x, wk, sc, b, out_clip=7.0)
    assert torch.equal(got, k12.ct2x2_int8_reference(x, wk, sc, b,
                                                     out_clip=7.0))
    assert int(got.abs().max()) == 7


@pytest.mark.parametrize("mode", [True, "w4", "a4"])
def test_w4a4_graph_kernels_match_plain(dev, mode):
    """The w4a4 graph (f=16) on the kernels equals its plain graph, with
    the fused head too; K1 18, K2 4 launches per forward."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference.psrp import (
        quantize_unet_psrp,
    )

    model = build_model(num_classes=5, init_features=16, seed=0, device=dev)
    _, calib = build_psrp_forward(model, image_size=64, device=dev)
    qp = quantize_unet_psrp(calib["layers"], calib["taps"], 16,
                            deep_int4=mode, device=dev)
    x = preprocess(torch.tensor(
        np.random.default_rng(23).uniform(0, 255, (2, 64, 64, 1)),
        dtype=torch.float32, device=dev))
    with torch.inference_mode():
        before = k12.conv3x3_int8.launches, k12.ct2x2_int8.launches
        got = unet_psrp_forward(qp, x, 5, head_fuse=False)
        torch.cuda.synchronize()
        assert (k12.conv3x3_int8.launches - before[0],
                k12.ct2x2_int8.launches - before[1]) == (18, 4)
        want = unet_psrp_forward(qp, x, 5, reference=True)
        fused = unet_psrp_forward(qp, x, 5, head_fuse=True)
    assert torch.equal(got, want) and torch.equal(fused, want)


# K1's tensor-core body: calls that conv3x3_plan puts on it


def _k1_mma_case(rng, dev, n, h, w, cins, cout, knobs, nc=0):
    """Seeded inputs of one K1 call: +-7 values where an input is padded
    with -7 (w4a4), else the int8 range; a scale that spreads the outputs
    over the clip range."""
    four = -7 in (knobs.get("pad_vals") or ())
    xs = tuple(_i8(rng, (n, h, w, c), dev, *((-7, 8) if four else ()))
               for c in cins)
    wq = _i8(rng, (cout, sum(cins), 3, 3), dev, -40, 40)
    std = (9 * sum(cins)) ** 0.5 * 23 * (4 if four else 73)
    clip = knobs.get("out_clip", 127.0)
    sc = _vec(rng, cout, clip / 4 / std, clip / 2 / std, dev)
    b = _vec(rng, cout, -clip / 20, clip / 20, dev)
    kw = dict(knobs)
    if nc:
        kw["head"] = (
            k3.pack_head_weights(_i8(rng, (nc, cout, 1, 1), dev, -40, 40)),
            _vec(rng, nc, 1e-3, 2e-3, dev), _vec(rng, nc, -1, 1, dev))
    return (xs, k12.pack_conv3x3_weights(wq), sc, b), kw, \
        k12.pack_conv3x3_mma_weights(wq)


K1_MMA_CASES = [  # (n, h, w, cins, cout, knobs, head classes, co_t, warps)
    (2, 64, 48, (32,), 32, dict(pool=True), 0, 32, 4),
    (1, 34, 48, (32,), 64, dict(pool=True, relu=False), 0, 32, 4),  # partial
    (2, 32, 32, (64,), 128, {}, 0, 32, 8),
    (2, 34, 48, (128,), 64, dict(pool=True), 0, 32, 8),
    (2, 32, 32, (256,), 128, dict(pool=True), 0, 64, 8),
    (1, 34, 48, (128, 128), 128, dict(pad_vals=(0, -7), relu=False,
                                       out_clip=7.0), 0, 64, 8),
    (1, 34, 48, (32, 32), 32, dict(pad_vals=(0, -7), relu=False,
                                   out_clip=7.0), 0, 32, 8),
    (1, 33, 47, (64, 64), 32, dict(pad_vals=(0, -7), relu=False,
                                   out_clip=7.0), 0, 32, 8),    # odd H, W
    (2, 32, 48, (32,), 32, dict(pool=True, pool_rescale=14 / 127,
                                pool_shift=-7.0, pool_clip=7.0), 0, 32, 4),
    (1, 34, 48, (64,), 64, dict(pool=True, pad_vals=(-7,),
                                pool_rescale=14 / 127, pool_shift=-7.0,
                                pool_clip=7.0), 0, 32, 8),
    (1, 33, 47, (64,), 64, dict(pad_vals=(-7,), relu=False, out_clip=7.0),
     0, 32, 8),                                                 # odd H, W
    (2, 8, 8, (512,), 512, {}, 0, 64, 8),
    (2, 34, 48, (32,), 32, {}, 10, 32, 4),                      # head
    (1, 32, 32, (64,), 32, dict(pad_vals=(-7,)), 32, 32, 8),    # head
    (1, 34, 48, (128,), 32, {}, 10, 32, 8),                     # head
]


@pytest.mark.parametrize("n,h,w,cins,cout,knobs,nc,co_t,warps",
                         K1_MMA_CASES)
def test_k1_mma_body_matches_plain(dev, n, h, w, cins, cout, knobs, nc,
                                   co_t, warps):
    """The plan puts the call on the mma.sync body (at co_t channels and
    ``warps`` warps a block); its outputs equal the plain version bit for
    bit, with w_mma given and packed in the call, and a repeated call
    gives the same bits; one launch a call."""
    rng = np.random.default_rng(24)
    args, kw, wm = _k1_mma_case(rng, dev, n, h, w, cins, cout, knobs, nc)
    plan = k12.conv3x3_plan(n, h, w, cins, cout, nc > 0)
    assert (plan.body, plan.co_t, plan.warps) == ("mma", co_t, warps)
    want = k12.conv3x3_int8_reference(*args, **kw)
    before = k12.conv3x3_int8.launches
    got = k12.conv3x3_int8(*args, w_mma=wm, **kw)
    again = k12.conv3x3_int8(*args, w_mma=wm, **kw)
    packed_here = k12.conv3x3_int8(*args, **kw)
    torch.cuda.synchronize()
    assert k12.conv3x3_int8.launches == before + 3
    many = isinstance(want, tuple)
    for out in (got, again, packed_here):
        for g_, w_ in zip(out if many else (out,), want if many else (want,)):
            assert torch.equal(g_, w_)
    y = want[0] if many else want
    if not nc:  # the outputs are spread, not all clipped
        assert len(torch.unique(y)) > 8


def test_k1_mma_rejects_bad_weights(dev):
    """Admitted calls check w_mma's shape; the plan admits by the inputs'
    channel counts and alignment alone."""
    rng = np.random.default_rng(25)
    args, kw, wm = _k1_mma_case(rng, dev, 1, 16, 16, (64,), 32, {})
    with pytest.raises(ValueError, match="mma weights"):
        k12.conv3x3_int8(*args, w_mma=wm[:1])
    x = torch.empty(1 * 16 * 16 * 64 + 4, dtype=torch.int8, device=dev)
    xs = (x[4:].view(1, 16, 16, 64).copy_(args[0][0]),)
    assert k12.conv3x3_plan(1, 16, 16, (64,), 32, False, False).body == "dp4a"
    assert torch.equal(k12.conv3x3_int8(xs, *args[1:], w_mma=wm),
                       k12.conv3x3_int8_reference(xs, *args[1:]))


# K1's stem body: the Cin=1 calls that conv3x3_plan puts on it


def _k1_stem_case(rng, dev, n, h, w, cout, extremes=False):
    """Seeded inputs of one stem call (+-127 inputs and weights with
    ``extremes``) and its packed stem weights."""
    if extremes:
        vals = np.array([-127, 127])
        x = torch.tensor(rng.choice(vals, (n, h, w, 1)), dtype=torch.int8,
                         device=dev)
        wq = torch.tensor(rng.choice(vals, (cout, 1, 3, 3)), dtype=torch.int8,
                          device=dev)
        x[0, :3, :3] = 127
        wq[0] = 127  # pixel (0, 1, 1), channel 0: 9 * 127^2
        std = 3 * 127 ** 2
    else:
        x, wq = _i8(rng, (n, h, w, 1), dev), _i8(rng, (cout, 1, 3, 3), dev)
        std = 3 * 73 ** 2
    sc, b = _vec(rng, cout, 30 / std, 60 / std, dev), _vec(rng, cout, -5, 5,
                                                          dev)
    return ((x,), k12.pack_conv3x3_weights(wq), sc, b), \
        k12.pack_stem_mma_weights(wq)


@pytest.mark.parametrize("n,h,w", [(2, 64, 64), (2, 80, 48), (1, 512, 512)])
@pytest.mark.parametrize("cout", [16, 32])
def test_k1_stem_body_matches_plain(dev, n, h, w, cout):
    """The plan puts the stem on the stem body; its output equals the
    plain version bit for bit, with w_mma given and packed in the call,
    and a repeated call gives the same bits; one launch a call."""
    rng = np.random.default_rng(26)
    args, wm = _k1_stem_case(rng, dev, n, h, w, cout)
    plan = k12.conv3x3_plan(n, h, w, (1,), cout)
    assert (plan.body, plan.co_t, plan.warps) == ("stem", cout, 8)
    want = k12.conv3x3_int8_reference(*args)
    before = k12.conv3x3_int8.launches
    got = k12.conv3x3_int8(*args, w_mma=wm)
    again = k12.conv3x3_int8(*args, w_mma=wm)
    packed_here = k12.conv3x3_int8(*args)
    torch.cuda.synchronize()
    assert k12.conv3x3_int8.launches == before + 3
    for out in (got, again, packed_here):
        assert torch.equal(out, want)
    assert len(torch.unique(want)) > 8


@pytest.mark.parametrize("cout", [16, 32, 64])
def test_k1_stem_body_extremes(dev, cout):
    """+-127 inputs and weights (|acc| up to 9 * 127^2) bit for bit."""
    rng = np.random.default_rng(27)
    args, wm = _k1_stem_case(rng, dev, 2, 64, 64, cout, extremes=True)
    got = k12.conv3x3_int8(*args, w_mma=wm)
    want = k12.conv3x3_int8_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got.max()) == 127


@pytest.mark.parametrize("grid", [1, 3, 40])
def test_k1_stem_body_knobs_and_grids(dev, grid):
    """Border value -7, no relu and clip 7 through the wrapper; and the C
    entry point at persistent grids of 1, 3 and 40 blocks (each walks
    several tiles through both halo buffers), bit for bit."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )

    rng = np.random.default_rng(28)
    n, h, w, cout = 2, 80, 48, 32
    args, wm = _k1_stem_case(rng, dev, n, h, w, cout)
    knobs = dict(pad_vals=(-7,), relu=False, out_clip=7.0)
    assert torch.equal(k12.conv3x3_int8(*args, w_mma=wm, **knobs),
                       k12.conv3x3_int8_reference(*args, **knobs))
    plan = k12.conv3x3_plan(n, h, w, (1,), cout)
    y = torch.empty((n, h, w, cout), dtype=torch.int8, device=dev)
    (x,), _, sc, b = args
    _build.check(_build.lib().octseg_conv3x3_int8_stem(
        x.data_ptr(), wm.data_ptr(), sc.data_ptr(), b.data_ptr(), y.data_ptr(),
        n, h, w, cout, 1, 0, 127.0, grid, plan.smem,
        torch.cuda.current_stream().cuda_stream), "stem")
    torch.cuda.synchronize()
    assert torch.equal(y, k12.conv3x3_int8_reference(*args))


def test_k1_stem_rejects_bad_weights(dev):
    """The stem body checks w_mma's shape; a misaligned input goes to the
    dp4a body and gives the same bits."""
    rng = np.random.default_rng(29)
    args, wm = _k1_stem_case(rng, dev, 1, 32, 32, 32)
    with pytest.raises(ValueError, match="stem weights"):
        k12.conv3x3_int8(*args, w_mma=wm[:16])
    x = torch.empty(32 * 32 + 4, dtype=torch.int8, device=dev)
    xs = (x[4:].view(1, 32, 32, 1).copy_(args[0][0]),)
    assert k12.conv3x3_plan(1, 32, 32, (1,), 32, False, False).body == "dp4a"
    assert torch.equal(k12.conv3x3_int8(xs, *args[1:], w_mma=wm),
                       k12.conv3x3_int8_reference(xs, *args[1:]))


# K10's mma.sync body: the c1 = cout = 32 calls that stem_conv_plan puts on it


def _k10_mma_case(rng, dev, n, h, w, extremes=False):
    """Seeded inputs of one f=32 fused-stem call (K1's packs, then the
    scales and biases) and its tensor-core packs ``(w0_m, w1_m)``; with
    ``extremes`` +-127 inputs and weights, a block of 127s whose stem
    clips in every channel and conv1's channel 0 all 127 (288 * 127^2
    there). Stem biases up to 40: a halo that held the stem of a
    zero-padded image would show at the border."""
    if extremes:
        vals = np.array([-127, 127])
        x = torch.tensor(rng.choice(vals, (n, h, w, 1)), dtype=torch.int8,
                         device=dev)
        x[0, 4:11, 4:11] = 127
        w0 = torch.full((32, 1, 3, 3), 127, dtype=torch.int8, device=dev)
        w1 = torch.tensor(rng.choice(vals, (32, 32, 3, 3)), dtype=torch.int8,
                          device=dev)
        w1[0] = 127
        s0 = _vec(rng, 32, 1.0 / (9 * 127), 1.5 / (9 * 127), dev)
        b0 = _vec(rng, 32, -5, 40, dev)
        s1 = _vec(rng, 32, 30 / (17 * 64 * 127), 60 / (17 * 64 * 127), dev)
    else:
        x = _i8(rng, (n, h, w, 1), dev)
        w0, w1 = _i8(rng, (32, 1, 3, 3), dev), _i8(rng, (32, 32, 3, 3), dev)
        s0 = _vec(rng, 32, 30 / (3 * 73 ** 2), 60 / (3 * 73 ** 2), dev)
        b0 = _vec(rng, 32, -5, 40, dev)
        s1 = _vec(rng, 32, 30 / (17 * 64 * 73), 60 / (17 * 64 * 73), dev)
    b1 = _vec(rng, 32, -5, 5, dev)
    args = (x, k12.pack_conv3x3_weights(w0), s0, b0,
            k12.pack_conv3x3_weights(w1), s1, b1)
    return args, (k12.pack_stem_mma_weights(w0),
                  k12.pack_conv3x3_mma_weights(w1))


@pytest.mark.parametrize("n,h,w", [(2, 512, 512), (3, 14, 48), (1, 80, 16)])
def test_k10_mma_body_matches_plain(dev, n, h, w):
    """The plan puts the f=32 fused stem on the mma.sync body (the served
    shape, a ragged one with H % 4 == 2 and three warp tiles a row, one
    warp tile a row); both outputs equal the plain version bit for bit,
    with w_mma given and packed in the call; one launch a call."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    rng = np.random.default_rng(30)
    args, wm = _k10_mma_case(rng, dev, n, h, w)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert k10.stem_conv_plan(n, h, w, 32, 32, sms=sms).body == "mma"
    want = k10.stem_conv_int8_reference(*args)
    before = k10.stem_conv_int8.launches
    got = k10.stem_conv_int8(*args, wm)
    packed_here = k10.stem_conv_int8(*args)
    torch.cuda.synchronize()
    assert k10.stem_conv_int8.launches == before + 2
    for out in (got, packed_here):
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    assert len(torch.unique(want[0])) > 8


def test_k10_mma_body_extremes(dev):
    """+-127 inputs and weights, the stem's clip and conv1's largest sum
    (288 * 127^2, beyond 2^22) bit for bit."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    rng = np.random.default_rng(31)
    args, wm = _k10_mma_case(rng, dev, 2, 64, 64, extremes=True)
    got = k10.stem_conv_int8(*args, wm)
    want = k10.stem_conv_int8_reference(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got[0][0, 7, 7, 0]) == 127


def test_k10_mma_body_repeats_bit_for_bit(dev):
    """Three calls on the same inputs give the same bits (int32 sums, no
    atomics), and the C entry point at persistent grids of 1 and 7 blocks
    (each walks several bands) gives them too."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        _build,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    rng = np.random.default_rng(32)
    n, h, w = 2, 64, 96
    args, wm = _k10_mma_case(rng, dev, n, h, w)
    first = k10.stem_conv_int8(*args, wm)
    for _ in range(2):
        again = k10.stem_conv_int8(*args, wm)
        assert all(torch.equal(a, b) for a, b in zip(again, first))
    plan = k10.stem_conv_plan(n, h, w, 32, 32)
    x, _, s0, b0, _, s1, b1 = args
    for grid, band in ((1, 16), (7, 8)):
        y = torch.empty_like(first[0])
        yp = torch.empty_like(first[1])
        _build.check(_build.lib().octseg_stem_conv_int8_mma(
            x.data_ptr(), wm[0].data_ptr(), s0.data_ptr(), b0.data_ptr(),
            wm[1].data_ptr(), s1.data_ptr(), b1.data_ptr(), y.data_ptr(),
            yp.data_ptr(), n, h, w, band, grid, plan.smem,
            torch.cuda.current_stream().cuda_stream), "K10 mma")
        torch.cuda.synchronize()
        assert torch.equal(y, first[0]) and torch.equal(yp, first[1])


def test_k10_plan_choice_on_the_card(dev):
    """At this card's SM count: the f=32 stem on the mma.sync body, f=16
    on the dp4a body, both equal to the plain version."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert k10.stem_conv_plan(32, 512, 512, 32, 32, sms=sms).body == "mma"
    assert k10.stem_conv_plan(32, 512, 512, 16, 16, sms=sms).body == "dp4a"
    rng = np.random.default_rng(33)
    x = _i8(rng, (2, 64, 64, 1), dev)
    w0 = k12.pack_conv3x3_weights(_i8(rng, (16, 1, 3, 3), dev, -40, 40))
    w1 = k12.pack_conv3x3_weights(_i8(rng, (16, 16, 3, 3), dev, -40, 40))
    s0, b0 = _vec(rng, 16, 0.05, 0.1, dev), _vec(rng, 16, 10, 40, dev)
    s1, b1 = _vec(rng, 16, 1e-3, 3e-3, dev), _vec(rng, 16, -5, 5, dev)
    got = k10.stem_conv_int8(x, w0, s0, b0, w1, s1, b1)
    want = k10.stem_conv_int8_reference(x, w0, s0, b0, w1, s1, b1)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k10_mma_rejects_bad_weights(dev):
    """The mma.sync body checks both tensor-core packs' shapes and
    alignment; a misaligned image goes to the dp4a body and gives the
    same bits."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops import (
        stem_conv_int8 as k10,
    )

    rng = np.random.default_rng(34)
    args, (w0m, w1m) = _k10_mma_case(rng, dev, 1, 32, 32)
    with pytest.raises(ValueError, match="stem mma weights"):
        k10.stem_conv_int8(*args, (w0m[:16], w1m))
    with pytest.raises(ValueError, match="conv1 mma weights"):
        k10.stem_conv_int8(*args, (w0m, w1m[:, :8]))
    with pytest.raises(ValueError, match="conv1 mma weights"):
        k10.stem_conv_int8(*args, (w0m, w1m.reshape(9, 32, 32)))
    buf = torch.empty(32 * 32 + 4, dtype=torch.int8, device=dev)
    x = buf[4:].view(1, 32, 32, 1).copy_(args[0])
    assert k10.stem_conv_plan(1, 32, 32, 32, 32, aligned=False).body == "dp4a"
    got = k10.stem_conv_int8(x, *args[1:], (w0m, w1m))
    want = k10.stem_conv_int8_reference(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
