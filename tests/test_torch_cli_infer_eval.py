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
def test_unported_flags_raise(tmp_path, argv, match):
    """``--spatial`` (item 12) raises, naming its item. The flags of item
    11 are ported: a missing directory raises what the JAX CLI raises."""
    if match == "item 12":
        with pytest.raises(NotImplementedError, match=match):
            _port([argv[0], *_args("unet"), *argv[1:]])
        return
    argv = [a.replace("/x", str(tmp_path / "missing")) for a in argv]
    with pytest.raises(Exception) as jax_error:
        jcli.main([argv[0], *_args("unet"), *argv[1:]])
    assert isinstance(jax_error.value, FileNotFoundError)
    with pytest.raises(FileNotFoundError, match="missing"):
        _port([argv[0], *_args("unet"), *argv[1:]])


def test_refused_combinations():
    with pytest.raises(SystemExit, match="int8|psrp"):
        _port(["infer", *_args("relaynet"), "--quantize", "packed"])
    with pytest.raises(ValueError, match="init_features=32"):
        _port(["infer", *_args("unet"), "--quantize", "packed"])
    with pytest.raises(SystemExit, match="U-Net only"):
        _port(["infer", *_args("relaynet"), "--quantize", "psrp",
               "--save-quantized", "x.npz"])


# ------------------------------------------------------ real data, folders


DUKE_NC = 9  # the Duke DME classes: background, 7 layers, fluid


def _duke_dir(root, n=3):
    """``n`` synthetic Duke DME v5 volumes (72 x 80, 5 B-scans, all
    annotated) in the published layout."""
    import scipy.io as sio

    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.duke import (
        synthetic_duke_dme_volume,
    )

    root.mkdir()
    for i in range(n):
        sio.savemat(root / f"Subject_{i:02d}.mat", synthetic_duke_dme_volume(
            np.random.default_rng(i), 72, 80, 5, range(5)))
    return str(root)


def _jax_state_from(model, monkeypatch):
    """Make the JAX trainer's ``init_state`` start from ``model``'s
    weights (the JAX CLI reads Orbax checkpoints, not torch ones)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training import (
        trainer as jtrainer,
    )
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.utils.convert import (
        unet_variables_from_state_dict,
    )

    v = unet_variables_from_state_dict(model.state_dict())
    init = jtrainer.Trainer.init_state

    def init_state(self, sample):
        state = init(self, sample)
        return state.replace(params=v["params"],
                             batch_stats=v["batch_stats"])

    monkeypatch.setattr(jtrainer.Trainer, "init_state", init_state)


def test_eval_data_prints_what_jax_prints_on_the_same_weights(
        tmp_path, capsys, monkeypatch):
    """``eval --data duke:DIR``: both CLIs raise --num-classes to the
    dataset's 9, score the validation split (the last volume) with the
    same weights, and print the same metric lines."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.models.unet import (
        UNet,
    )

    root = _duke_dir(tmp_path / "duke")
    model = UNet(1, DUKE_NC, 8, generator=torch.Generator().manual_seed(3))
    ckpt = tmp_path / "unet.pt"
    torch.save(model.state_dict(), ckpt)
    _jax_state_from(model, monkeypatch)
    argv = ["eval", *_args("unet"), "--data", f"duke:{root}"]
    want = jcli.main(argv)
    want_lines = [line for line in capsys.readouterr().out.splitlines()
                  if _printed(line)]
    got = _port([*argv, "--checkpoint", str(ckpt)])
    got_lines = [line for line in capsys.readouterr().out.splitlines()
                 if _printed(line)]
    assert _printed("\n".join(got_lines)) == list(METRIC_LINES)
    assert got_lines == want_lines
    assert int(got["confusion"].sum()) == 4 * HW * HW  # 2 batches of 2
    assert got["dice"].shape == (DUKE_NC,)
    for k in METRIC_LINES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-4,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("quantize", ["int8", "psrp"])
def test_eval_data_quantized_scores_the_graphs_masks(tmp_path, quantize):
    """``eval --data --quantize``: the validation split through the graph
    ``build_quantized_forward`` builds, scored as ``Trainer.evaluate``
    scores it."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.data import (
        make_datasets,
    )

    root = _duke_dir(tmp_path / "duke")
    m = _port(["eval", *_args("unet"), "--data", f"duke:{root}",
               "--quantize", quantize])
    args = cli.parser().parse_args(["eval", *_args("unet"), "--device",
                                    "cpu"])
    trainer, state = cli.build_eval_trainer(args, DUKE_NC)
    forward, _ = cli.build_quantized_forward(
        trainer.model, "unet", quantize, image_size=HW, device="cpu")
    _, val, _ = make_datasets(f"duke:{root}", (HW, HW), 2)
    want = trainer.evaluate(state, val, predict_fn=lambda s, x: forward(x))
    np.testing.assert_array_equal(m["confusion"], want["confusion"])
    assert m["confusion"].shape == (DUKE_NC, DUKE_NC)


@pytest.mark.parametrize("packed", [[], ["--packed"]],
                         ids=["unpacked", "packed"])
def test_train_data_raises_the_classes_as_jax(tmp_path, capsys, packed):
    """``train --data duke:DIR --num-classes 2``: the note and the class
    count JAX's CLI gives (its dataset reader says 9), one epoch of steps
    on the CPU."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu.training.data import (
        make_datasets as jax_make_datasets,
    )

    root = _duke_dir(tmp_path / "duke")
    argv = ["train", "--device", "cpu", "--image-size", "32",
            "--batch-size", "2", "--epochs", "1", "--num-classes", "2",
            "--model-kwargs", '{"init_features": 4}', "--data",
            f"duke:{root}", *packed]
    nc = jax_make_datasets(f"duke:{root}", (32, 32), 2)[2]
    assert nc == DUKE_NC
    trainer, train_ds, val_ds = cli.build_training(cli.parser().parse_args(
        argv))
    note = f"note: dataset has {nc} classes; overriding --num-classes 2"
    assert note in capsys.readouterr().out
    assert trainer.cfg.model.num_classes == nc
    assert train_ds.steps_per_epoch == 5 and val_ds.steps_per_epoch == 2
    state = cli.main(argv)
    assert note in capsys.readouterr().out
    assert state.step == 5
    assert state.model.conv.out_channels == nc


def _image_dir(root, n=2, h=HW, w=HW):
    from PIL import Image

    root.mkdir()
    rng = np.random.default_rng(4)
    for i in range(n):
        img = rng.integers(0, 255, (h, w)).astype(np.uint8)
        Image.fromarray(img).save(root / f"bscan_{i}.png")
    return str(root)


@pytest.mark.parametrize("quantize", ["off", "psrp"])
def test_infer_image_dir_writes_masks(tmp_path, capsys, quantize):
    """``infer --image-dir``: a mask for every image of the folder, the
    forward's labels of the images as read; ``--export-probs`` names the
    maps after the images, as the JAX CLI does (two 64x64 images: the JAX
    CLI reuses the program it compiled for the synthetic batch above)."""
    from retinal_oct_image_segmentation_via_deep_learning_tpu_torch.training.fouriernet_pipeline import (
        read_folder_dataset,
    )

    folder = _image_dir(tmp_path / "img")
    out = tmp_path / "out"
    _port(["infer", *_args("unet"), "--image-dir", folder, "--quantize",
           quantize, "--out-dir", str(out), "--export-probs"])
    assert f"wrote 2 masks to {out}" in capsys.readouterr().out
    masks = np.load(out / "masks.npy", allow_pickle=False)
    assert masks.shape == (2, HW, HW) and masks.dtype == np.int32
    images = torch.from_numpy(read_folder_dataset(folder)[0][..., None])
    trainer, state = cli.build_eval_trainer(cli.parser().parse_args(
        ["infer", *_args("unet"), "--device", "cpu"]))
    with torch.inference_mode():
        if quantize == "off":
            want = trainer.predict(state, images)
        else:
            want = cli.build_quantized_forward(
                trainer.model, "unet", quantize, image_size=HW,
                device="cpu")[0](images)
    np.testing.assert_array_equal(masks, want.numpy())
    jout = tmp_path / "jax"
    jcli.main(["infer", *_args("unet"), "--image-dir", folder, "--out-dir",
               str(jout), "--export-probs"])
    assert sorted(p.name for p in out.iterdir()) == \
        sorted(p.name for p in jout.iterdir())
    assert np.load(jout / "masks.npy").shape == masks.shape
