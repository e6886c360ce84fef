"""The port's w4a4 serving mode (``--quantize int4``) against the JAX
package's, on the CPU.

* K1 and K2's plain versions with the w4a4 knobs (``out_clip=7``, -7
  borders, the split-scale pool, K2's per-column bias), bit for bit against
  JAX's lax reference and its Pallas kernels in interpret mode (which keep
  int8 dots: the +-7 operands make ``dot_int4`` change no value);
* ``quantize_unet_psrp`` in every 4-bit mode: weights, scales and
  ``wsum4`` bit-equal to JAX's, and every layer's epilogue (scale, bias,
  relu, clip, border values, pool rescale) equal to what JAX's graph hands
  its kernels (read by running that graph with its kernels replaced by
  recorders);
* the graph at f=16, 64x64: given JAX's w4a4 qparams, the labels of JAX's
  w4a4 graph; with the port's own fold and calibration, the contract of
  tests/test_int4_deep.py (> 0.90 against the all-int8 graph, > 0.85
  against float); the fused head and stem switches;
* ``cli infer|eval|serve --quantize int4`` (tests/test_cli_int4.py's cases)
  and the int4 artifacts.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    artifacts as ja,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    psrp as jpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.inference import (
    quantized as jq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    pallas_conv_int8 as jk,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu.ops import (
    pallas_conv_psrp as jp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    artifacts as ta,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    psrp as tpsrp,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.inference import (
    quantized as tq,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
    UNet,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.ops.conv_int8 import (
    conv3x3_int8,
    ct2x2_int8,
    pack_conv3x3_weights,
    pack_ct2x2_weights,
)
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
    unet_qparams_from_jax,
    unet_state_dict_from_jax,
)
from test_torch_common import (
    agreement,
    jax_unet,
    normal_images,
    port_psrp_labels_full_pipeline,
    port_psrp_labels_given_jax_qparams,
    psrp_reference_case,
)

F, NC, HW = 16, 10, 64
ZP7_RESCALE = 1.0 / (127.0 / 14.0)  # JAX's pool_rescale (psrp.py)
MODES = [True, "w4", "a4"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i4(rng, shape, lo=-7, hi=8):
    return rng.integers(lo, hi, shape).astype(np.int8)


def _port_conv(xs, w_hwio, scale, bias, **kw):
    w = pack_conv3x3_weights(_t(w_hwio.transpose(3, 2, 0, 1)))
    return conv3x3_int8(tuple(_t(x) for x in xs), w, _t(scale), _t(bias),
                        **kw)


# ---------------------------------------------------------------------------
# K1 and K2 with the w4a4 knobs
# ---------------------------------------------------------------------------


# tests/test_int4_deep.py's four conv cases: (seed, input shapes and value
# ranges, cout, bias range, knobs)
CONV_CASES = {
    "out_clip7": (0, [((2, 16, 32, 128), -7)], 128, 0.5,
                  dict(out_clip=7.0)),
    "cat": (1, [((1, 8, 16, 64), -7), ((1, 8, 16, 64), 0)], 64, 0.0,
            dict(out_clip=7.0)),
    "zp_pad": (3, [((2, 16, 32, 128), -7)], 128, 0.5,
               dict(out_clip=7.0, pad_vals=(-7,), relu=False)),
    "cat_mixed_pad": (4, [((1, 8, 16, 64), -7), ((1, 8, 16, 64), -7)], 64,
                      0.0, dict(out_clip=7.0, pad_vals=(0, -7), relu=False)),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_k1_w4a4_vs_conv3x3_int8(case):
    """K1's plain version against JAX's ``conv3x3_int8_reference`` and its
    Pallas ``conv3x3_int8(dot_int4=True)`` in interpret mode."""
    seed, inputs, cout, b, kw = CONV_CASES[case]
    rng = np.random.default_rng(seed)
    xs = [_i4(rng, shape, lo) for shape, lo in inputs]
    cin = sum(s[-1] for s, _ in inputs)
    w = _i4(rng, (3, 3, cin, cout))
    scale = rng.uniform(0.001, 0.01, cout).astype(np.float32)
    bias = rng.uniform(-b, b, cout).astype(np.float32)
    got = _port_conv(xs, w, scale, bias, **kw).numpy()
    wp = jnp.asarray(jk.pack_weights(w, 1))
    xj = tuple(jnp.asarray(x) for x in xs)
    sj, bj = jnp.asarray(scale), jnp.asarray(bias)
    ref = jk.conv3x3_int8_reference(xj if len(xj) > 1 else xj[0], wp, sj, bj,
                                    by=1, **kw)
    np.testing.assert_array_equal(got, np.asarray(ref))
    kern = jk.conv3x3_int8(xj, wp, sj, bj, by=1, th=4, interpret=True,
                           dot_int4=True, **kw)
    np.testing.assert_array_equal(got, np.asarray(kern))
    assert np.abs(got.astype(np.int32)).max() <= 7
    if kw.get("pad_vals"):  # the -7 border is load-bearing
        zero_pad = _port_conv(xs, w, scale, bias,
                              **{**kw, "pad_vals": None}).numpy()
        assert not np.array_equal(got, zero_pad)


def test_k2_w4a4_per_column_bias_vs_ct2x2_int8():
    """K2's plain version with out_clip=7 and a (2, 2*cout) bias against
    JAX's ``ct2x2_int8(dot_int4=True)`` in interpret mode."""
    rng = np.random.default_rng(2)
    cin, cout = 128, 64
    x = _i4(rng, (2, 8, 8, cin))
    w = _i4(rng, (2, 2, cin, cout))
    scale = rng.uniform(0.001, 0.01, cout).astype(np.float32)
    bias = rng.uniform(-3, 3, (2, 2 * cout)).astype(np.float32)
    want = jk.ct2x2_int8(
        jnp.asarray(x), tuple(jnp.asarray(m) for m in jk.pack_ct2x2_weights(w)),
        jnp.asarray(scale), jnp.asarray(bias), tr=4, interpret=True,
        dot_int4=True, out_clip=7.0)
    wp = pack_ct2x2_weights(_t(w.transpose(2, 3, 0, 1)))
    got = ct2x2_int8(_t(x), wp, _t(scale), _t(bias.reshape(-1)),
                     out_clip=7.0).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert np.abs(got.astype(np.int32)).max() == 7
    # a per-channel bias is a different function here
    same = ct2x2_int8(_t(x), wp, _t(scale), _t(bias[0, :cout]),
                      out_clip=7.0).numpy()
    assert not np.array_equal(got, same)


def _psrp(xs, w, scale, bias, by, nph, **kw):
    cins = tuple(x.shape[-1] for x in xs)
    return jp.conv3x3_psrp(
        tuple(jp.pack_psrp(jnp.asarray(x), by, nph) for x in xs),
        tuple(jnp.asarray(m) for m in jp.pack_psrp_weights(w, by, nph)[0]),
        jnp.asarray(scale), jnp.asarray(bias), by=by, nph=nph, cins=cins,
        tg=2, interpret=True, **kw)


@pytest.mark.parametrize("by,nph", [(2, 2), (4, 4)])
def test_k1_zp7_border_vs_conv3x3_psrp(by, nph):
    """blk1_conv0 / blk7_conv1: a zero-point-7 input padded with -7, a
    zero-point-7 output (no relu, clip 7)."""
    rng = np.random.default_rng(5)
    x = _i4(rng, (2, 16, 16, 16))
    w = _i4(rng, (3, 3, 16, 16))
    scale = rng.uniform(0.01, 0.05, 16).astype(np.float32)
    bias = rng.uniform(-3, 3, 16).astype(np.float32)
    kw = dict(relu=False, out_clip=7.0)
    want = jp.unpack_psrp(_psrp([x], w, scale, bias, by, nph, pad_val=-7,
                                dot_int4=True, **kw), by, nph)
    got = _port_conv([x], w, scale, bias, pad_vals=(-7,), **kw).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    zero_pad = _port_conv([x], w, scale, bias, **kw).numpy()
    assert not np.array_equal(got, zero_pad)


def _crafted_pool_case():
    """All-zero input, scale 1: every output is its channel's bias, chosen
    within two float32 ulps of m where fmaf(m, 14/127, -7) = k + 0.5. An FMA
    and a product rounded before the sum disagree on some of them."""
    r = np.float64(np.float32(ZP7_RESCALE))
    bias = []
    for k in range(-7, 7):
        m = np.float32((k + 7.5) / r)
        for d in (-2, -1, 0, 1, 2):
            v = m
            for _ in range(abs(d)):
                v = np.nextafter(v, np.float32(np.inf if d > 0 else -np.inf))
            bias.append(v)
    bias = np.asarray(bias, np.float32)
    rng = np.random.default_rng(7)
    x = np.zeros((1, 8, 8, 8), np.int8)
    w = rng.integers(-20, 20, (3, 3, 8, bias.size)).astype(np.int8)
    return x, w, np.ones(bias.size, np.float32), bias


@pytest.mark.parametrize("case", ["random", "fma_ties"])
def test_k1_split_scale_pool_vs_conv3x3_psrp(case):
    """blk0_conv1 / blk1_conv1: the unpooled output at 8 bits, the pool
    requantized from the float32 values before rounding:
    clip(rint(fmaf(max, 14/127, -7)), +-7)."""
    if case == "random":
        rng = np.random.default_rng(6)
        x = rng.integers(0, 100, (2, 16, 16, 8)).astype(np.int8)
        w = rng.integers(-20, 20, (3, 3, 8, 8)).astype(np.int8)
        scale = rng.uniform(1e-3, 2e-3, 8).astype(np.float32)
        bias = rng.uniform(-3, 3, 8).astype(np.float32)
    else:
        x, w, scale, bias = _crafted_pool_case()
    by = nph = 4
    kw = dict(pool_rescale=ZP7_RESCALE, pool_shift=-7.0, pool_clip=7.0)
    full, pooled = _psrp([x], w, scale, bias, by, nph, pool=True, **kw)
    want = np.asarray(jp.unpack_psrp(full, by, nph))
    want_pool = np.asarray(jp.unpack_psrp(pooled, by // 2, nph // 2))
    got, got_pool = _port_conv([x], w, scale, bias, pool=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got_pool.numpy(), want_pool)
    assert np.abs(want_pool.astype(np.int32)).max() <= 7
    if case == "fma_ties":  # the case separates one rounding from two
        m = bias.reshape(1, 1, 1, -1)
        two = np.clip(np.round((m * np.float32(ZP7_RESCALE)).astype(
            np.float32) - np.float32(7)), -7, 7)
        assert (two != want_pool).any()


# ---------------------------------------------------------------------------
# quantization and the per-layer epilogues
# ---------------------------------------------------------------------------


# JAX's graph calls its kernels in this order (inference/psrp.py)
JAX_CALL_ORDER = (
    ["blk0_conv0", "blk0_conv1", "blk1_conv0", "blk1_conv1"]
    + [f"blk{i}_conv{j}" for i in (2, 3, 4) for j in (0, 1)]
    + ["ct0", "blk5_conv0", "blk5_conv1", "ct1", "blk6_conv0", "blk6_conv1",
       "ct2", "blk7_conv0", "blk7_conv1", "ct3", "blk8_conv0", "blk8_conv1",
       "head"])
JAX_KERNELS = ("stem_psrp", "conv3x3_psrp", "conv3x3_int8", "ct2x2_int8",
               "ct_up_psrp", "ct_psrp", "head_argmax_psrp")


def jax_epilogues(qp, x, nc, monkeypatch):
    """{layer: (scale, bias, knobs)} that JAX's ``unet_psrp_forward`` hands
    its kernels, its TPU path taken (the CPU path runs the int8 deep stages
    through the eager ``_qconv``): each kernel is replaced by a recorder
    that returns zeros of its output's shape."""
    calls = []

    def recorder(name):
        real = getattr(jpsrp, name)

        def fn(*args, **kw):
            calls.append((name, args[2], args[3], kw))
            out = jax.eval_shape(
                functools.partial(real, **{**kw, "interpret": True}), *args)
            return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), out)

        return fn

    for name in JAX_KERNELS:
        monkeypatch.setattr(jpsrp, name, recorder(name))
    with monkeypatch.context() as m:
        m.setattr(jax, "default_backend", lambda: "tpu")
        jpsrp.unet_psrp_forward(qp, jnp.asarray(x), nc, tg=4)
    assert len(calls) == len(JAX_CALL_ORDER)
    return {layer: (np.asarray(sc), np.asarray(b), kw)
            for layer, (_, sc, b, kw) in zip(JAX_CALL_ORDER, calls)}


@pytest.fixture(scope="module")
def folded():
    _, v = jax_unet(F, NC, HW)
    j = jq.fold_unet_bn(v)
    model = UNet(1, NC, F)
    model.load_state_dict(unet_state_dict_from_jax(v))
    taps = jq.calibrate_unet(j, [normal_images(0, 2, HW)])
    return j, tq.fold_unet_bn(model), taps


def _hwio(name, w_q):
    perm = (2, 3, 0, 1) if name.startswith("ct") else (2, 3, 1, 0)
    return w_q.numpy().transpose(perm)


@pytest.mark.parametrize("mode,w8", [
    (True, ()), ("w4", ()), ("a4", ()), (True, ("blk4_conv0", "ct1")),
])
def test_quantize_and_epilogues_bit_equal(folded, monkeypatch, mode, w8):
    j, t, taps = folded
    jqp = jpsrp.quantize_unet_psrp(j, taps, init_features=F, deep_int4=mode,
                                   int4_w8_stages=w8)
    tqp = tpsrp.quantize_unet_psrp(t, taps, init_features=F, deep_int4=mode,
                                   int4_w8_stages=w8)
    flags = sorted(k for k in jqp if k.startswith(("_deep_", "_w8_")))
    assert flags == sorted(k for k in tqp if k.startswith(("_deep_", "_w8_")))
    for name in j:
        np.testing.assert_array_equal(_hwio(name, tqp[name]["w_q"]),
                                      jqp[name]["w_q"], name)
        np.testing.assert_array_equal(tqp[name]["s_w"].numpy(),
                                      jqp[name]["s_w"], name)
        assert ("wsum4" in tqp[name]) == ("wsum4" in jqp[name]), name
        if "wsum4" in jqp[name]:
            np.testing.assert_array_equal(tqp[name]["wsum4"].numpy(),
                                          jqp[name]["wsum4"], name)
    lim = {name: int(np.abs(jqp[name]["w_q"]).max()) for name in j}
    assert lim["blk3_conv1"] == (7 if mode in (True, "w4") else 127)
    assert lim["blk4_conv0"] == (127 if w8 or mode == "a4" else 7)
    want = jax_epilogues(jax.tree.map(jnp.asarray, jqp),
                         normal_images(1, 1, HW), NC, monkeypatch)
    for name, (scale, bias, kw) in want.items():
        lw = tqp[name]
        np.testing.assert_array_equal(lw["scale"].numpy(), scale, name)
        np.testing.assert_array_equal(lw["bias"].numpy(), bias.reshape(-1),
                                      name)
        knobs = lw.get("knobs", {})
        assert knobs.get("out_clip", 127.0) == kw.get("out_clip", 127.0), name
        if "relu" in knobs:  # K1
            pads = kw.get("pad_vals") or (
                (kw["pad_val"],) if kw.get("pad_val") else None)
            assert (knobs["relu"], knobs["pad_vals"]) == (
                kw.get("relu", True), pads), name
            if kw.get("pool"):
                assert (knobs["pool_rescale"], knobs["pool_shift"],
                        knobs["pool_clip"] or knobs["out_clip"]) == (
                    kw.get("pool_rescale"), kw.get("pool_shift", 0.0),
                    kw.get("pool_clip", 127.0)), name


# ---------------------------------------------------------------------------
# the graph
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def case():
    return psrp_reference_case(F, deep_int4=True)


def test_w4a4_graph_given_jax_qparams(case):
    lab = port_psrp_labels_given_jax_qparams(case)
    assert lab.dtype == torch.int8 and lab.shape == (2, HW, HW)
    differ = int((lab.numpy() != case["psrp"]).sum())
    print(f"w4a4 labels differing from JAX's: {differ} of {lab.numel()}")
    assert agreement(lab, case["psrp"]) >= 0.999


def test_w4a4_graph_full_pipeline(case):
    """The port's fold, calibration and w4a4 quantization keep the JAX
    graph's contract (tests/test_int4_deep.py)."""
    lab = port_psrp_labels_full_pipeline(case)
    assert agreement(lab, case["int8"]) > 0.90
    assert agreement(lab, case["float"]) > 0.85


@pytest.mark.parametrize("mode", [False] + MODES)
def test_fused_head_labels_equal_unfused(case, monkeypatch, mode):
    model = UNet(1, NC, F)
    model.load_state_dict(unet_state_dict_from_jax(case["variables"]))
    layers = tq.fold_unet_bn(model)
    taps = tq.calibrate_unet(layers, [normal_images(0, 2, HW)])
    qp = tpsrp.quantize_unet_psrp(layers, taps, init_features=F,
                                  deep_int4=mode)
    x = torch.from_numpy(case["x"])
    unfused = tpsrp.unet_psrp_forward(qp, x, NC, head_fuse=False)
    assert torch.equal(tpsrp.unet_psrp_forward(qp, x, NC, head_fuse=True),
                       unfused)
    monkeypatch.setenv("OCTSEG_PSRP_HEAD_FUSE", "1")
    monkeypatch.setenv("OCTSEG_PSRP_STEM_FUSE", "1")
    # both switches on; under 4-bit activations the stem one is ignored
    assert torch.equal(tpsrp.unet_psrp_forward(qp, x, NC), unfused)
    if tpsrp.act4(qp):
        with pytest.raises(ValueError, match="split-scale"):
            tpsrp.unet_psrp_forward(qp, x, NC, stem_fuse=True)


# ---------------------------------------------------------------------------
# the CLI and the artifacts
# ---------------------------------------------------------------------------


UNET_ARGS = [
    "--model", "unet", "--num-classes", "6", "--image-size", "64",
    "--batch-size", "2", "--dtype", "float32",
    "--model-kwargs", '{"init_features": 16}', "--device", "cpu",
]


def test_cli_infer_unet_int4(tmp_path):
    out = tmp_path / "masks_int4"
    cli.main(["infer", *UNET_ARGS, "--quantize", "int4",
              "--out-dir", str(out)])
    masks = np.load(out / "masks.npy")
    assert masks.shape == (2, 64, 64)
    assert masks.min() >= 0 and masks.max() < 6


def test_cli_eval_unet_int4():
    m = cli.main(["eval", *UNET_ARGS, "--quantize", "int4",
                  "--num-val", "2"])
    assert 0.0 <= m["pixel_accuracy"] <= 1.0


def test_cli_relaynet_int4_rejected():
    for cmd in (["eval", "--num-val", "2"], ["infer"]):
        with pytest.raises(SystemExit):
            cli.main([cmd[0], "--model", "relaynet", "--num-classes", "5",
                      "--image-size", "64", "--batch-size", "2",
                      "--model-kwargs", '{"num_filters": 8}', "--device",
                      "cpu", "--quantize", "int4", *cmd[1:]])


def test_cli_serve_builds_the_int4_graph():
    args = cli.parser().parse_args(["serve", "--quantize", "int4"])
    assert args.quantize == "int4"
    model = cli.build_model(num_classes=6, init_features=16, device="cpu")
    forward, calib = cli.build_quantized_forward(
        model, "unet", "int4", image_size=64, device="cpu")
    assert "_deep_int4" in calib["qparams"]
    x = torch.from_numpy(normal_images(2, 2, 64))
    with torch.inference_mode():
        assert forward(x).shape == (2, 64, 64)
    with pytest.raises(SystemExit, match="psrp"):
        cli.build_quantized_forward(
            cli.build_model("relaynet", num_classes=6, init_features=8,
                            device="cpu"),
            "relaynet", "int4", image_size=64, device="cpu")


def test_int4_artifact_round_trip_and_mode_checks(tmp_path):
    art = str(tmp_path / "q.npz")
    for flag, out in (("--save-quantized", "a"), ("--load-quantized", "b")):
        cli.main(["infer", *UNET_ARGS, "--quantize", "int4",
                  "--out-dir", str(tmp_path / out), flag, art])
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "masks.npy"),
                                  np.load(tmp_path / "b" / "masks.npy"))
    raw = ta.load_qparams(art, "int4")
    assert raw["_deep_int4"] is True and "wsum4" in raw["blk3_conv0"]
    with pytest.raises(ValueError, match="an? int4 artifact, but --quantize "
                                         "psrp"):
        ta.load_qparams(art, "psrp")
    cli.main(["infer", *UNET_ARGS, "--quantize", "psrp", "--out-dir",
              str(tmp_path / "c"), "--save-quantized", art])
    with pytest.raises(ValueError, match="psrp artifact, but --quantize "
                                         "int4"):
        cli.main(["infer", *UNET_ARGS, "--quantize", "int4", "--out-dir",
                  str(tmp_path / "d"), "--load-quantized", art])


def test_jax_int4_artifact_loads(tmp_path, case):
    """JAX's w4a4 artifact (TPU packs, wsum4, mode keys) gives the labels
    of the same qparams handed over in memory."""
    path = str(tmp_path / "jax_int4.npz")
    ja.save_qparams(path, case["qparams"])
    loaded = ta.load_qparams(path, "int4")
    assert loaded["_deep_int4"] is True
    x = torch.from_numpy(case["x"])
    assert torch.equal(
        tpsrp.unet_psrp_forward(tpsrp.attach_kernel_params(loaded), x, NC),
        port_psrp_labels_given_jax_qparams(case))
    want = unet_qparams_from_jax(case["qparams"])
    for name, lw in want.items():
        if isinstance(lw, dict):
            for k, v in lw.items():
                assert torch.equal(loaded[name][k], v), (name, k)
