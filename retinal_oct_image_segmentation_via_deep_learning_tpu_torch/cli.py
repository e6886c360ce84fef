"""Command line: ``serve`` an int8 model over HTTP, ``train`` a model.

    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        serve --model unet|relaynet --quantize psrp --image-size 512 \\
        --device cuda [--init-features F] [--checkpoint state_dict.pt] \\
        [--seed 0]
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        train --packed --image-size 512 --device cuda [--epochs 10] ...

The served forward is built by ``build_psrp_forward`` (the U-Net) or
``build_relaynet_psrp_forward`` (ReLayNet): model -> BN fold -> calibration
on a seeded standard-normal batch (after the same preprocessing the
requests get) -> int8 quantization -> the served graph, behind the
per-image z-score. ``train`` builds its trainer and synthetic
datasets with ``build_training``. ``chip_smoke.py`` builds both the same way.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .config import DataConfig, ModelConfig, OptimConfig, TrainConfig
from .inference.http_server import serve_forever
from .inference.psrp import quantize_unet_psrp, unet_psrp_forward
from .inference.quantized import calibrate_unet, fold_unet_bn
from .inference.relaynet_int8 import calibrate_relaynet, fold_relaynet_bn
from .inference.relaynet_psrp import (
    quantize_relaynet_psrp,
    relaynet_psrp_forward,
)
from .inference.server import ServingLoop
from .ops.preprocess import preprocess
from .registry import get_model
from .training.data import SyntheticOCTConfig, SyntheticOCTDataset
from .training.trainer import Trainer
from .utils.logging import MetricLogger


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


def build_psrp_forward(model: torch.nn.Module, *, image_size: int, device,
                       seed: int = 0):
    """-> (forward, calib): ``forward(images)`` maps (N, H, W, 1) float
    images on ``device`` to (N, H, W) int8 labels through the int8 graph;
    ``calib`` holds the folded ``layers``, the ``taps`` and the served
    ``qparams``."""
    device = torch.device(device)
    layers = fold_unet_bn(model)
    with torch.inference_mode():
        taps = calibrate_unet(layers,
                              [_calibration_batch(image_size, device, seed)])
    f = int(layers["blk0_conv0"]["w"].shape[0])
    qparams = quantize_unet_psrp(layers, taps, init_features=f, device=device)
    num_classes = int(qparams["head"]["w_k"].shape[0])

    def forward(images: torch.Tensor) -> torch.Tensor:
        return unet_psrp_forward(qparams, preprocess(images), num_classes)

    return forward, {"layers": layers, "taps": taps, "qparams": qparams}


def build_relaynet_psrp_forward(model: torch.nn.Module, *, image_size: int,
                                device, seed: int = 0):
    """``build_psrp_forward`` for ReLayNet: -> (forward, calib) with
    ``forward(images)`` mapping (N, H, W, 1) float images on ``device`` to
    (N, H, W) int8 labels through ``relaynet_psrp_forward``, calibrated as
    the U-Net is."""
    device = torch.device(device)
    layers = fold_relaynet_bn(model)
    with torch.inference_mode():
        taps = calibrate_relaynet(
            layers, [_calibration_batch(image_size, device, seed)])
    qparams = quantize_relaynet_psrp(layers, taps, device=device)
    num_classes = int(qparams["head"]["w_k"].shape[0])

    def forward(images: torch.Tensor) -> torch.Tensor:
        return relaynet_psrp_forward(qparams, preprocess(images), num_classes)

    return forward, {"layers": layers, "taps": taps, "qparams": qparams}


SERVED_FORWARDS = {"unet": build_psrp_forward,
                   "relaynet": build_relaynet_psrp_forward}


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device available")
    return device


def build_training(args):
    """-> (trainer, train_ds, val_ds) for ``train``'s arguments: the
    config as the JAX CLI builds it, synthetic Duke-DME-shaped data made on
    the device (validation from seed 99)."""
    if args.data:
        raise NotImplementedError(
            f"--data {args.data}: the real-data loaders are not ported yet "
            "(ROADMAP.md, Queue A item 11); omit --data for synthetic data"
        )
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


def cmd_serve(args) -> None:
    device = _device(args.device)
    if args.checkpoint is None:
        print("note: no --checkpoint given; using random init from --seed")
    model = build_model(args.model, num_classes=args.num_classes,
                        init_features=args.init_features, seed=args.seed,
                        checkpoint=args.checkpoint, device=device)
    forward, _ = SERVED_FORWARDS[args.model](
        model, image_size=args.image_size, device=device, seed=args.seed)
    loop = ServingLoop(forward, (args.image_size, args.image_size, 1),
                       device=device, batch_size=args.batch_size,
                       max_wait_ms=args.max_wait_ms)
    serve_forever(loop, host=args.host, port=args.port)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="octseg-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve",
                       help="HTTP serving of the int8 U-Net or ReLayNet")
    s.add_argument("--model", default="unet", choices=list(WIDTH_ARGS))
    s.add_argument("--quantize", default="psrp", choices=["psrp"],
                   help="int8 graph on the CUDA kernels (the only mode "
                        "ported so far)")
    s.add_argument("--num-classes", type=int, default=10)
    s.add_argument("--init-features", type=int, default=None,
                   help="model width (ReLayNet: num_filters); default the "
                        "model's own, 32 for unet, 64 for relaynet")
    s.add_argument("--image-size", type=int, default=512)
    s.add_argument("--device", default="cuda")
    s.add_argument("--checkpoint", default=None,
                   help="torch state dict of the model (.pt)")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--batch-size", type=int, default=8)
    s.add_argument("--max-wait-ms", type=float, default=2.0)
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8765)
    s.set_defaults(fn=cmd_serve)

    t = sub.add_parser("train", help="train a model on synthetic data")
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
                   help="real dataset spec (not ported yet: raises)")
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
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
