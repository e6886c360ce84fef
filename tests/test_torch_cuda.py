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
                                   (4, 33, 130)])
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
    want = k89.dice_ce_bwd_reference(x, lab, coef)
    assert dx.dtype == dtype and dx.shape == x.shape
    exact = k89.dice_ce_bwd_reference(x.double(), lab, coef)
    err = (dx.double() - exact).abs()
    ulp = (_bf16_ulp(want) if dtype == torch.bfloat16
           else want.float().abs().clamp_min(2.0 ** -126) * 2.0 ** -23)
    floor = 2.0 ** -20 * float(exact.abs().max())
    assert bool((err <= ulp.double() + floor).all())


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
