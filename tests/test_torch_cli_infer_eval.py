"""``cli infer`` and ``cli eval`` of the port on the CPU at 64x64: what they
write and print, beside the JAX CLI's own runs of the same commands.

The two CLIs draw their synthetic B-scans from different generators (JAX's
PRNG is not reproduced), so the values differ and only the outputs' form is
compared with JAX; the metric values themselves are held against JAX in
tests/test_torch_metrics.py. The masks of each quantized mode are held to
the graph that ``build_quantized_forward`` builds.
"""

import numpy as np
import pytest
import torch

from retinal_oct_image_segmentation_via_deep_learning_tpu import cli as jcli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch import cli
from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
    SyntheticOCTConfig,
    synth_batch,
)

NC, HW = 5, 64
COMMON = ["--num-classes", str(NC), "--image-size", str(HW),
          "--batch-size", "2", "--dtype", "float32"]
WIDTH = {"unet": '{"init_features": 8}', "relaynet": '{"num_filters": 8}'}
METRIC_LINES = ("pixel_accuracy", "dice", "iou", "sensitivity",
                "specificity", "precision", "hd95", "assd",
                "thickness_diff", "vi_diff")


def _args(model, f=None):
    width = WIDTH[model] if f is None else f'{{"init_features": {f}}}'
    return ["--model", model, *COMMON, "--model-kwargs", width]


def _port(argv):
    return cli.main([argv[0], *argv[1:], "--device", "cpu"])


def _images(seed=0):
    g = torch.Generator().manual_seed(seed)
    return synth_batch(g, 2, SyntheticOCTConfig(height=HW, width=HW,
                                                num_layers=NC - 2))[0]


@pytest.mark.parametrize("model,quantize,f", [
    ("unet", "int8", None), ("unet", "psrp", None), ("unet", "packed", 32),
    ("relaynet", "int8", None), ("relaynet", "psrp", None),
])
def test_infer_quantized_writes_the_graphs_masks(tmp_path, capsys, model,
                                                 quantize, f):
    out = tmp_path / "out"
    _port(["infer", *_args(model, f), "--quantize", quantize,
           "--out-dir", str(out)])
    assert f"wrote 2 masks to {out}" in capsys.readouterr().out
    masks = np.load(out / "masks.npy", allow_pickle=False)
    assert masks.shape == (2, HW, HW) and masks.dtype == np.int32
    trainer, _ = cli.build_eval_trainer(cli.parser().parse_args(
        ["infer", *_args(model, f), "--device", "cpu"]))
    forward, _ = cli.build_quantized_forward(
        trainer.model, model, quantize, image_size=HW, device="cpu")
    with torch.inference_mode():
        np.testing.assert_array_equal(masks, forward(_images()).numpy())


def test_infer_off_writes_what_jax_writes(tmp_path, capsys):
    """The float model's masks and ``--export-probs`` maps: the same files,
    shapes, types and text format as the JAX CLI's."""
    outs = {}
    for name, main in (("port", _port), ("jax", jcli.main)):
        out = tmp_path / name
        main(["infer", *_args("unet"), "--out-dir", str(out),
              "--export-probs"])
        outs[name] = out
        assert f"wrote 2 masks to {out}" in capsys.readouterr().out
    files = {k: sorted(p.name for p in v.iterdir()) for k, v in outs.items()}
    assert files["port"] == files["jax"] == [
        "masks.npy", "prob_0000.txt", "prob_0001.txt"]
    port, jax_ = (np.load(outs[k] / "masks.npy") for k in ("port", "jax"))
    assert port.dtype == jax_.dtype and port.shape == jax_.shape
    prob = np.loadtxt(outs["port"] / "prob_0000.txt")
    assert prob.shape == (HW, HW) and 0 <= prob.min() <= prob.max() <= 1


def test_save_then_load_quantized_gives_the_same_masks(tmp_path):
    art = str(tmp_path / "q.npz")
    for flag, out in (("--save-quantized", "a"), ("--load-quantized", "b")):
        _port(["infer", *_args("unet", 32), "--quantize", "packed",
               "--out-dir", str(tmp_path / out), flag, art])
    np.testing.assert_array_equal(np.load(tmp_path / "a" / "masks.npy"),
                                  np.load(tmp_path / "b" / "masks.npy"))
    with pytest.raises(ValueError, match="a packed artifact"):
        _port(["infer", *_args("unet", 32), "--quantize", "psrp",
               "--out-dir", str(tmp_path / "c"), "--load-quantized", art])


def _printed(text):
    """The metric names of the printed metric lines, in order."""
    names = [line.split()[0].rstrip(":") for line in text.splitlines()
             if line.strip()]
    return [n for n in names if n in METRIC_LINES]


@pytest.mark.parametrize("model,quantize", [
    ("unet", "off"), ("unet", "int8"), ("unet", "psrp"),
    ("relaynet", "psrp"),
])
def test_eval_prints_the_jax_lines(capsys, model, quantize):
    """The metric lines of the JAX CLI, in its order; the confusion counts
    cover every pixel of the --num-val B-scans."""
    m = _port(["eval", *_args(model), "--quantize", quantize,
               "--num-val", "4"])
    assert _printed(capsys.readouterr().out) == list(METRIC_LINES)
    assert int(m["confusion"].sum()) == 4 * HW * HW
    for k in METRIC_LINES[1:]:
        assert m[k].shape == (NC,)


def test_eval_off_prints_what_jax_prints(capsys):
    jcli.main(["eval", *_args("unet"), "--num-val", "2"])
    want = _printed(capsys.readouterr().out)
    _port(["eval", *_args("unet"), "--num-val", "2"])
    assert want == list(METRIC_LINES)
    assert _printed(capsys.readouterr().out) == want


@pytest.mark.parametrize("argv,match", [
    (["infer", "--spatial", "4"], "item 12"),
    (["eval", "--data", "retouch:/x"], "item 11"),
    (["infer", "--spatial", "2"], "item 12"),
    (["eval", "--data", "duke:/x"], "item 11"),
    (["infer", "--image-dir", "/x"], "item 11"),
])
def test_unported_flags_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        _port([argv[0], *_args("unet"), *argv[1:]])


def test_refused_combinations():
    with pytest.raises(SystemExit, match="int8|psrp"):
        _port(["infer", *_args("relaynet"), "--quantize", "packed"])
    with pytest.raises(ValueError, match="init_features=32"):
        _port(["infer", *_args("unet"), "--quantize", "packed"])
    with pytest.raises(SystemExit, match="U-Net only"):
        _port(["infer", *_args("relaynet"), "--quantize", "psrp",
               "--save-quantized", "x.npz"])
