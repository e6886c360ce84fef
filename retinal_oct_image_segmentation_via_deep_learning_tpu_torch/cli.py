"""Command line: ``serve`` an int8 model over HTTP, ``train`` a model,
``infer`` masks for a batch of B-scans, ``eval`` a model on the metric
suite, ``smoke`` every ported model with one forward.

    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        serve --model unet|relaynet --quantize off|int8|psrp|int4 \\
        --image-size 512 --device cuda [--init-features F] \\
        [--checkpoint state_dict.pt | --load-quantized q.npz] [--seed 0]
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        train --packed --image-size 512 --device cuda [--epochs 10] \\
        [--data duke:DIR|retouch:DIR|png:DIR] ...
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        infer --model unet --quantize off|int8|packed|psrp|int4 \\
        --out-dir DIR [--image-dir DIR] [--export-probs] \\
        [--save-quantized q.npz | --load-quantized q.npz]
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        eval --model unet|relaynet --quantize off|int8|psrp|int4 \\
        [--num-val 16 | --data duke:DIR|retouch:DIR|png:DIR]
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        smoke --model all|unet|relaynet|sdnet [--num-classes 10] --device cuda

The int8 graphs are built by ``build_quantized_forward``: model -> BN fold
-> calibration on a seeded standard-normal batch (after the same
preprocessing the images get) -> int8 quantization -> the graph, behind the
per-image z-score. ``psrp``, ``int4`` (the U-Net's w4a4 mode of the psrp
graph) and ``packed`` run on the CUDA kernels; ``int8`` is the all-int8
oracle graph in plain PyTorch (the JAX package runs it in XLA); ``off`` is
the float model (``build_float_forward``). ``serve`` serves any of them
but ``packed``, from the model or a quantized artifact. ``train`` builds its
trainer and datasets with ``build_training``. Without ``--data`` and
``--image-dir``, ``train``, ``infer`` and ``eval`` run on synthetic B-scans
made on the device from ``--seed`` (eval's from seed 99, as ``train``'s
validation data); ``--data`` reads a real dataset (``training/data.py``,
eval scoring its validation split), ``--image-dir`` a folder of B-scans.
``chip_smoke.py`` builds all of them the same way.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from .config import DataConfig, ModelConfig, OptimConfig, TrainConfig
from .inference.artifacts import load_qparams, save_qparams
from .inference.http_server import serve_forever
from .inference.packed import (
    attach_packed_params,
    quantize_unet_packed,
    unet_packed_forward,
)
from .inference.psrp import (
    attach_kernel_params,
    quantize_unet_psrp,
    unet_psrp_forward,
)
from .inference.quantized import (
    calibrate_unet,
    fold_unet_bn,
    quantize_unet,
    unet_int8_forward,
)
from .inference.relaynet_int8 import (
    calibrate_relaynet,
    fold_relaynet_bn,
    quantize_relaynet,
    relaynet_int8_forward,
)
from .inference.relaynet_psrp import (
    quantize_relaynet_psrp,
    relaynet_psrp_forward,
)
from .inference.server import ServingLoop
from .ops.preprocess import preprocess
from .registry import get_model, list_models
from .training.data import (
    SyntheticOCTConfig,
    SyntheticOCTDataset,
    make_datasets,
    synth_batch,
)
from .training.fouriernet_pipeline import read_folder_dataset
from .training.trainer import Trainer, nhwc_logits
from .utils.dtype import resolve_dtype
from .utils.logging import MetricLogger, export_prob_maps


# the constructor argument that sets each served model's width
WIDTH_ARGS = {"unet": "init_features", "relaynet": "num_filters"}


def build_model(name: str = "unet", *, num_classes: int,
                init_features: int | None = None, seed: int = 0,
                checkpoint: str | None = None, device) -> torch.nn.Module:
    """The model to serve: random init from ``seed``, or a saved state
    dict (``torch.save(model.state_dict(), path)``). ``init_features`` sets
    the width (ReLayNet's ``num_filters``); ``None`` takes the model's
    default (32 for the U-Net, 64 for ReLayNet)."""
    if name not in WIDTH_ARGS:
        raise ValueError(f"model {name!r}: the served models are "
                         f"{', '.join(WIDTH_ARGS)}")
    width = {} if init_features is None else {WIDTH_ARGS[name]: init_features}
    model = get_model(name, in_channels=1, num_classes=num_classes,
                      seed=seed, **width)
    if checkpoint:
        model.load_state_dict(
            torch.load(checkpoint, map_location="cpu", weights_only=True)
        )
    return model.to(device).eval()


def _calibration_batch(image_size: int, device, seed: int) -> torch.Tensor:
    """Two seeded standard-normal images after the preprocessing the
    requests get (zeros would z-score to zeros and collapse every
    activation scale)."""
    calib = np.random.default_rng(seed).standard_normal(
        (2, image_size, image_size, 1)
    ).astype(np.float32)
    return preprocess(torch.from_numpy(calib).to(device))


def _to(q: dict, device) -> dict:
    """Raw int8 qparams on ``device``."""
    return {name: {k: v.to(device) for k, v in lw.items()}
            for name, lw in q.items()}


# (model, --quantize) -> (quantize(layers, taps, device), attach raw
# qparams to ``device``, graph(qparams, x, num_classes) -> labels)
GRAPHS = {
    ("unet", "psrp"): (
        lambda layers, taps, dev: quantize_unet_psrp(
            layers, taps, int(layers["blk0_conv0"]["w"].shape[0]),
            device=dev),
        attach_kernel_params, unet_psrp_forward),
    ("unet", "int4"): (
        lambda layers, taps, dev: quantize_unet_psrp(
            layers, taps, int(layers["blk0_conv0"]["w"].shape[0]),
            deep_int4=True, device=dev),
        attach_kernel_params, unet_psrp_forward),
    ("unet", "packed"): (
        lambda layers, taps, dev: quantize_unet_packed(
            layers, taps, int(layers["blk0_conv0"]["w"].shape[0]),
            device=dev),
        attach_packed_params, unet_packed_forward),
    ("unet", "int8"): (
        lambda layers, taps, dev: quantize_unet(layers, taps), _to,
        lambda q, x, nc: unet_int8_forward(q, x).argmax(-1)),
    ("relaynet", "psrp"): (
        lambda layers, taps, dev: quantize_relaynet_psrp(layers, taps,
                                                         device=dev),
        None, relaynet_psrp_forward),
    ("relaynet", "int8"): (
        lambda layers, taps, dev: quantize_relaynet(layers, taps), None,
        lambda q, x, nc: relaynet_int8_forward(q, x).argmax(-1)),
}
FOLDS = {"unet": (fold_unet_bn, calibrate_unet),
         "relaynet": (fold_relaynet_bn, calibrate_relaynet)}


def build_quantized_forward(model: torch.nn.Module, name: str = "unet",
                            quantize: str = "psrp", *, image_size: int,
                            device, seed: int = 0, qparams: dict | None = None):
    """-> (forward, calib): ``forward(images)`` maps (N, H, W, 1) float
    images on ``device`` to (N, H, W) labels through the ``quantize`` graph
    of model ``name``; ``calib`` holds the folded ``layers``, the ``taps``
    and the graph's ``qparams``. Given raw ``qparams`` (a loaded artifact,
    U-Net only), the model is neither folded nor calibrated."""
    if (name, quantize) not in GRAPHS:
        modes = "|".join(q for m, q in GRAPHS if m == name)
        raise SystemExit(f"--model {name} supports --quantize {modes}")
    device = torch.device(device)
    quant, attach, graph = GRAPHS[name, quantize]
    calib = {}
    if qparams is None:
        fold, calibrate = FOLDS[name]
        calib["layers"] = fold(model)
        with torch.inference_mode():
            calib["taps"] = calibrate(
                calib["layers"], [_calibration_batch(image_size, device, seed)])
        qparams = quant(calib["layers"], calib["taps"], device)
    else:
        qparams = attach(qparams, device)
    calib["qparams"] = qparams
    num_classes = int(qparams["head"]["w_q"].shape[0])

    def forward(images: torch.Tensor) -> torch.Tensor:
        return graph(qparams, preprocess(images), num_classes)

    return forward, calib


def build_float_forward(model: torch.nn.Module, dtype: str = "bfloat16"):
    """``forward(images)``: (N, H, W, 1) float images -> (N, H, W) labels
    through the float model in eval mode, computed in ``dtype`` (autocast;
    the parameters stay float32), behind the per-image z-score."""
    compute = resolve_dtype(dtype)
    model.eval()

    def forward(images: torch.Tensor) -> torch.Tensor:
        return nhwc_logits(model, preprocess(images), compute).argmax(-1)

    return forward


def build_psrp_forward(model: torch.nn.Module, *, image_size: int, device,
                       seed: int = 0):
    """``build_quantized_forward`` of the U-Net's served int8 graph
    (``inference/psrp.py``, on the CUDA kernels)."""
    return build_quantized_forward(model, "unet", "psrp",
                                   image_size=image_size, device=device,
                                   seed=seed)


def build_relaynet_psrp_forward(model: torch.nn.Module, *, image_size: int,
                                device, seed: int = 0):
    """``build_quantized_forward`` of ReLayNet's served int8 graph
    (``inference/relaynet_psrp.py``)."""
    return build_quantized_forward(model, "relaynet", "psrp",
                                   image_size=image_size, device=device,
                                   seed=seed)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device available")
    return device


def _with_classes(cfg: TrainConfig, num_classes: int) -> TrainConfig:
    """``cfg`` with ``num_classes`` classes where the dataset has more than
    ``--num-classes`` (the JAX CLI raises the count the same way)."""
    if num_classes <= cfg.model.num_classes:
        return cfg
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, num_classes=num_classes))


def build_training(args):
    """-> (trainer, train_ds, val_ds) for ``train``'s arguments: the
    config as the JAX CLI builds it; ``--data``'s dataset split by volume
    (``training/data.make_datasets``), or synthetic Duke-DME-shaped data
    made on the device (validation from seed 99)."""
    device = _device(args.device)
    cfg = TrainConfig(
        model=ModelConfig(
            name=args.model, in_channels=args.in_channels,
            num_classes=args.num_classes,
            kwargs=json.loads(args.model_kwargs) if args.model_kwargs else {},
        ),
        optim=OptimConfig(optimizer=args.optimizer, learning_rate=args.lr),
        data=DataConfig(
            image_size=(args.image_size, args.image_size),
            batch_size=args.batch_size, num_train=args.num_train,
            num_val=args.num_val,
        ),
        loss=args.loss,
        num_epochs=args.epochs,
        checkpoint_dir=args.checkpoint_dir,
        compute_dtype=args.dtype,
        early_stop_patience=args.patience,
        packed_train=args.packed,
    )
    real = make_datasets(args.data, cfg.data.image_size,
                         cfg.data.batch_size)
    if real is not None:
        train_ds, val_ds, num_classes = real
        if num_classes > cfg.model.num_classes:
            print(f"note: dataset has {num_classes} classes; overriding "
                  f"--num-classes {cfg.model.num_classes}")
            cfg = _with_classes(cfg, num_classes)
        return Trainer(cfg, device), train_ds, val_ds

    def dataset(num, seed):
        height, width = cfg.data.image_size
        dcfg = SyntheticOCTConfig(height=height, width=width,
                                  num_layers=max(args.num_classes - 2, 1),
                                  seed=seed)
        return SyntheticOCTDataset(dcfg, num, cfg.data.batch_size, device)

    return (Trainer(cfg, device), dataset(cfg.data.num_train, 0),
            dataset(cfg.data.num_val, 99))


def cmd_train(args):
    trainer, train_ds, val_ds = build_training(args)
    logger = MetricLogger(args.log_file)
    state = trainer.fit(train_ds, val_ds)
    for rec in trainer.history:
        logger.log(rec)
    return state


def _check_artifact_args(args) -> None:
    """Refuse artifact flags that the mode or the model cannot take."""
    if args.model != "unet" and (getattr(args, "save_quantized", None)
                                 or args.load_quantized):
        raise SystemExit("--save-quantized/--load-quantized: U-Net only")
    if args.load_quantized and args.quantize == "off":
        raise SystemExit("--load-quantized needs --quantize other than off")


def build_serving(args) -> ServingLoop:
    """The ``ServingLoop`` that ``serve`` runs: the float model
    (``--quantize off``) or an int8 graph, built from the model
    (``--checkpoint`` or random init from ``--seed``) or from a quantized
    artifact (``--load-quantized``)."""
    _check_artifact_args(args)
    device = _device(args.device)
    if args.checkpoint is None and not args.load_quantized:
        print("note: no --checkpoint given; using random init from --seed")
    model = build_model(args.model, num_classes=args.num_classes,
                        init_features=args.init_features, seed=args.seed,
                        checkpoint=args.checkpoint, device=device)
    if args.quantize == "off":
        forward = build_float_forward(model, args.dtype)
    else:
        loaded = (load_qparams(args.load_quantized, args.quantize)
                  if args.load_quantized else None)
        forward, _ = build_quantized_forward(
            model, args.model, args.quantize, image_size=args.image_size,
            device=device, seed=args.seed, qparams=loaded)
    return ServingLoop(forward, (args.image_size, args.image_size, 1),
                       device=device, batch_size=args.batch_size,
                       max_wait_ms=args.max_wait_ms)


def cmd_serve(args) -> None:
    serve_forever(build_serving(args), host=args.host, port=args.port)


def _refuse_unported(args) -> None:
    """``--spatial`` (not ported yet) raises, naming the ROADMAP.md item
    (Queue A) it waits for."""
    if getattr(args, "spatial", 1) > 1:
        raise NotImplementedError(
            "--spatial: spatially sharded inference is not ported yet "
            "(ROADMAP.md, Queue A item 12)")


def build_eval_trainer(args, num_classes: int = 0):
    """-> (trainer, state): the model of ``infer``/``eval``'s arguments as
    the JAX CLI builds it (``--model-kwargs``, random init from ``--seed``
    or ``--checkpoint``, a torch state dict), in eval mode on
    ``--device``; with ``num_classes`` classes where that is more than
    ``--num-classes``."""
    device = _device(args.device)
    cfg = TrainConfig(
        model=ModelConfig(
            name=args.model, in_channels=args.in_channels,
            num_classes=args.num_classes,
            kwargs=json.loads(args.model_kwargs) if args.model_kwargs else {},
        ),
        data=DataConfig(image_size=(args.image_size, args.image_size),
                        batch_size=args.batch_size),
        compute_dtype=args.dtype, seed=args.seed,
    )
    trainer = Trainer(_with_classes(cfg, num_classes), device)
    if args.checkpoint:
        trainer.model.load_state_dict(
            torch.load(args.checkpoint, map_location=device,
                       weights_only=True))
    else:
        print("note: no --checkpoint given; using random init from --seed")
    trainer.model.eval()
    return trainer, trainer.init_state()


def _synthetic_config(args, seed: int) -> SyntheticOCTConfig:
    return SyntheticOCTConfig(height=args.image_size, width=args.image_size,
                              num_layers=max(args.num_classes - 2, 1),
                              seed=seed)


def cmd_infer(args):
    """Masks for the B-scans of ``--image-dir`` (every image, grey levels)
    or a batch of synthetic ones -> ``--out-dir/masks.npy`` (int32
    labels), with ``--export-probs`` also the float model's class-1
    probability maps (``prob_0000.txt``, ..., or the images' names)."""
    _refuse_unported(args)
    _check_artifact_args(args)
    trainer, state = build_eval_trainer(args)
    names = None
    if args.image_dir:
        images, _, names = read_folder_dataset(args.image_dir)
        images = torch.from_numpy(images[..., None]).to(trainer.device)
    else:
        g = torch.Generator(device=trainer.device).manual_seed(args.seed)
        images, _ = synth_batch(g, args.batch_size,
                                _synthetic_config(args, args.seed))
    with torch.inference_mode():
        if args.quantize == "off":
            preds = trainer.predict(state, images)
        else:
            loaded = (load_qparams(args.load_quantized, args.quantize)
                      if args.load_quantized else None)
            forward, calib = build_quantized_forward(
                trainer.model, args.model, args.quantize,
                image_size=args.image_size, device=trainer.device,
                seed=args.seed, qparams=loaded)
            preds = forward(images)
            if args.save_quantized:
                save_qparams(args.save_quantized, calib["qparams"],
                             args.quantize)
                print(f"wrote quantized artifact to {args.save_quantized}")
        os.makedirs(args.out_dir, exist_ok=True)
        np.save(os.path.join(args.out_dir, "masks.npy"),
                preds.cpu().numpy().astype(np.int32))
        if args.export_probs:
            logits = trainer.model(
                trainer._preprocess(images.float()).permute(0, 3, 1, 2))
            probs = torch.softmax(logits.float(), dim=1)[:, 1]
            export_prob_maps(probs, args.out_dir, names)
    print(f"wrote {preds.shape[0]} masks to {args.out_dir}")
    return preds


def cmd_eval(args) -> dict:
    """The metric suite (``Trainer.evaluate``) over the validation split of
    ``--data`` or ``--num-val`` synthetic B-scans, through the float model
    or the ``--quantize`` graph; prints the JAX CLI's lines."""
    real = make_datasets(args.data, (args.image_size, args.image_size),
                         args.batch_size)
    if real is not None:
        _, ds, num_classes = real
        trainer, state = build_eval_trainer(args, num_classes)
    else:
        trainer, state = build_eval_trainer(args)
        ds = SyntheticOCTDataset(_synthetic_config(args, 99), args.num_val,
                                 args.batch_size, trainer.device)
    predict_fn = None
    if args.quantize != "off":
        forward, _ = build_quantized_forward(
            trainer.model, args.model, args.quantize,
            image_size=args.image_size, device=trainer.device, seed=args.seed)

        def predict_fn(_state, images):
            return forward(images.to(trainer.device))

    m = trainer.evaluate(state, ds, predict_fn=predict_fn)
    print(f"pixel_accuracy: {m['pixel_accuracy']:.4f}")
    for name in ("dice", "iou", "sensitivity", "specificity", "precision",
                 "hd95", "assd", "thickness_diff", "vi_diff"):
        if name in m:
            vals = " ".join(f"{v:.4f}" for v in m[name])
            print(f"{name:14s} per-class: {vals}")
    return m


def cmd_smoke(args) -> None:
    """One forward of each ported model (``--model all``: the registry) on
    a seeded standard-normal 64x64 B-scan, eval mode, random init; prints
    the JAX CLI's line. A name not ported raises."""
    device = _device(args.device)
    names = list_models() if args.model == "all" else [args.model]
    for name in names:
        t0 = time.time()
        size, kwargs, kw = 64, {}, {}
        if name == "sdnet":  # the JAX CLI's size and channels
            kwargs = {"img_size": size, "channels": (8, 16, 32, 64, 128)}
            kw = {"generator": torch.Generator(device=device).manual_seed(2)}
        model = get_model(name, num_classes=args.num_classes,
                          **kwargs).to(device)
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (1, 1, size, size)).astype(np.float32)).to(device)
        with torch.no_grad():
            out = model(x, **kw)
        shape = (tuple(out.shape) if isinstance(out, torch.Tensor) else
                 {k: (tuple(v.shape) if isinstance(v, torch.Tensor) else
                      {kk: tuple(vv.shape) for kk, vv in v.items()})
                  for k, v in out.items()})
        n_params = sum(p.numel() for p in model.parameters())
        print(f"{name:16s} ok  params={n_params:>12,}  "
              f"out={str(shape)[:80]}  ({time.time() - t0:.1f}s)")


def _eval_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's common flags, and ``--device``, ``--seed`` and
    ``--checkpoint`` (a torch state dict)."""
    p.add_argument("--model", default="unet", choices=list(WIDTH_ARGS))
    p.add_argument("--num-classes", type=int, default=10)
    p.add_argument("--in-channels", type=int, default=1)
    p.add_argument("--model-kwargs", default="",
                   help='JSON constructor overrides, e.g. \'{"init_features": 16}\'')
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--dtype", default="bfloat16",
                   help="compute dtype of the float model (--quantize off)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None,
                   help="torch state dict of the model (.pt)")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="octseg-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve",
                       help="HTTP serving of the U-Net or ReLayNet (int8 "
                            "graphs or the float model)")
    s.add_argument("--model", default="unet", choices=list(WIDTH_ARGS))
    s.add_argument("--quantize", default="psrp",
                   choices=["off", "int8", "psrp", "int4"],
                   help="the served graph: psrp (int8) or int4 (the U-Net's "
                        "w4a4 mode) on the CUDA kernels, int8 the all-int8 "
                        "oracle, off the float model")
    s.add_argument("--num-classes", type=int, default=10)
    s.add_argument("--init-features", type=int, default=None,
                   help="model width (ReLayNet: num_filters); default the "
                        "model's own, 32 for unet, 64 for relaynet")
    s.add_argument("--image-size", type=int, default=512)
    s.add_argument("--device", default="cuda")
    s.add_argument("--checkpoint", default=None,
                   help="torch state dict of the model (.pt)")
    s.add_argument("--load-quantized", default=None,
                   help="serve from a quantized artifact of the same "
                        "--quantize mode, written by infer --save-quantized "
                        "or by the JAX package (unet)")
    s.add_argument("--dtype", default="bfloat16",
                   help="compute dtype of the float model (--quantize off)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--max-wait-ms", type=float, default=2.0)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8765)
    s.set_defaults(fn=cmd_serve)

    t = sub.add_parser("train", help="train a model on a real dataset or "
                                     "synthetic data")
    t.add_argument("--model", default="unet")
    t.add_argument("--num-classes", type=int, default=10)
    t.add_argument("--in-channels", type=int, default=1)
    t.add_argument("--model-kwargs", default="",
                   help='JSON constructor overrides, e.g. \'{"init_features": 16}\'')
    t.add_argument("--image-size", type=int, default=256)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--dtype", default="bfloat16")
    t.add_argument("--device", default="cuda")
    t.add_argument("--data", default=None,
                   help="real dataset spec: duke:<dir> | retouch:<dir> | "
                        "png:<dir> (default: synthetic, made on the device)")
    t.add_argument("--epochs", type=int, default=10)
    t.add_argument("--lr", type=float, default=1e-3)
    t.add_argument("--optimizer", default="adam")
    t.add_argument("--loss", default="dice_ce")
    t.add_argument("--num-train", type=int, default=128)
    t.add_argument("--num-val", type=int, default=16)
    t.add_argument("--patience", type=int, default=50)
    t.add_argument("--checkpoint-dir", default=None)
    t.add_argument("--log-file", default=None)
    t.add_argument(
        "--packed", nargs="?", const=True, default=False,
        choices=[True, "remat"],
        help="the U-Net's training forward on the CUDA kernels "
             "(training/packed_unet.py; unet only); 'remat' also "
             "checkpoints each block",
    )
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="the metric suite on a real dataset's "
                                    "validation split or synthetic B-scans")
    _eval_args(e)
    e.add_argument("--num-val", type=int, default=16)
    e.add_argument("--quantize", default="off",
                   choices=("off", "int8", "psrp", "int4"),
                   help="evaluate an int8 graph instead of the float model "
                        "(int4: the U-Net's w4a4 mode of psrp)")
    e.add_argument("--data", default=None,
                   help="real dataset spec: duke:<dir> | retouch:<dir> | "
                        "png:<dir> (evaluates the validation split)")
    e.set_defaults(fn=cmd_eval)

    i = sub.add_parser("infer", help="masks for a batch of B-scans")
    _eval_args(i)
    i.add_argument("--image-dir", default=None,
                   help="a folder of B-scans (read with cv2 or PIL; "
                        "default: a batch of synthetic ones)")
    i.add_argument("--out-dir", default="./inference_out")
    i.add_argument("--export-probs", action="store_true")
    i.add_argument("--spatial", type=int, default=1,
                   help="spatial sharding (not ported yet: > 1 raises)")
    i.add_argument("--save-quantized", default=None,
                   help="write the quantized artifact (.npz) after "
                        "calibration (unet)")
    i.add_argument("--load-quantized", default=None,
                   help="serve from a quantized artifact of the same "
                        "--quantize mode, written here or by the JAX "
                        "package (unet)")
    i.add_argument("--quantize", default="off",
                   choices=("off", "int8", "packed", "psrp", "int4"),
                   help="int8 graphs: packed, psrp and int4 (its w4a4 "
                        "mode) (unet) on the CUDA kernels, int8 the all-int8 "
                        "oracle; relaynet takes int8|psrp")
    i.set_defaults(fn=cmd_infer)

    m = sub.add_parser("smoke", help="one forward of each ported model")
    m.add_argument("--model", default="all",
                   help="a registry name, or all (the ported models)")
    m.add_argument("--num-classes", type=int, default=10)
    m.add_argument("--device", default="cuda")
    m.set_defaults(fn=cmd_smoke)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
