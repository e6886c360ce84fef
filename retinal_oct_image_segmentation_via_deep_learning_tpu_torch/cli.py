"""Command line: ``serve`` an int8 model over HTTP, ``train`` a model,
``infer`` masks for a batch of B-scans, ``eval`` a model on the metric
suite, ``smoke`` every ported model with one forward.

    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        serve --model unet|relaynet --quantize off|int8|psrp|int4 \\
        --image-size 512 --device cuda [--init-features F] \\
        [--checkpoint ckpt.pt | --load-quantized q.npz] [--seed 0]
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        train --packed --image-size 512 --device cuda [--epochs 10] \\
        [--data duke:DIR|retouch:DIR|png:DIR] ...
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        infer --model NAME --quantize off|int8|packed|psrp|int4 \\
        --out-dir DIR [--image-dir DIR] [--export-probs] \\
        [--save-quantized q.npz | --load-quantized q.npz] [--spatial N]
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        eval --model NAME --quantize off|int8|psrp|int4 \\
        [--num-val 16 | --data duke:DIR|retouch:DIR|png:DIR]
    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        smoke --model all|NAME [--num-classes 10] --device cuda [--strict]

The int8 graphs are built by ``build_quantized_forward``: model -> BN fold
-> calibration on a seeded standard-normal batch (after the same
preprocessing the images get) -> int8 quantization -> the graph, behind the
per-image z-score. ``psrp``, ``int4`` (the U-Net's w4a4 mode of the psrp
graph) and ``packed`` run on the CUDA kernels; ``int8`` is the all-int8
oracle graph in plain PyTorch (the JAX package runs it in XLA); ``off`` is
the float model (``build_float_forward``), which ``infer`` and ``eval``
run for any registry model whose forward returns one tensor of logits
(not AnoGAN, FourierNet, SDNet, BioNet); the int8 modes take the U-Net and
ReLayNet. ``serve`` serves any of them
but ``packed``, from the model or a quantized artifact. ``train`` builds its
trainer and datasets with ``build_training``. Without ``--data`` and
``--image-dir``, ``train``, ``infer`` and ``eval`` run on synthetic B-scans
made on the device from ``--seed`` (eval's from seed 99, as ``train``'s
validation data); ``--data`` reads a real dataset (``training/data.py``,
eval scoring its validation split), ``--image-dir`` a folder of B-scans.
``train`` runs any such model through ``Trainer``; FourierNet and AnoGAN
have their own trainers, BioNet none (as in JAX). ``chip_smoke.py``
builds all of them the same way.

``train`` trains over every card of the host, as the JAX CLI's ``Trainer``
takes every local chip (``local_mesh()``): with ``--device cuda`` on a host
of k > 1 cards it starts k ranks (``parallel/launch.run_ranks``, NCCL, a
card each), and each rank trains on its shard of every global batch
(``--batch-size`` a multiple of k). Inside a process group that a caller
started, the ranks of that group are the data axis. On one card, on a
named card (``cuda:N``) or on the CPU it trains on one rank, with no
process group. Rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
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
from .parallel.halo import spatial_shard_infer
from .parallel.launch import run_ranks
from .parallel.mesh import create_mesh, local_mesh, world
from .parallel.sharding import tree_map
from .registry import get_model, list_models
from .training.checkpoint import model_state_dict
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
from .utils.profiling import annotate


# the constructor argument that sets each served model's width
WIDTH_ARGS = {"unet": "init_features", "relaynet": "num_filters"}
# models whose forward is not one tensor of logits, and the trainers of
# those that have their own
OWN_TRAINERS = {
    "fouriernet": "training/fouriernet_pipeline.FourierNetTrainer",
    "anogan": "training/adversarial.AnoGANTrainer",
}
# a forward of several tensors that no trainer of either package takes
OUTPUTS = {"bionet": "(seg_pred, gms_out, bio_out)"}
NOT_ONE_TENSOR = (*OWN_TRAINERS, "sdnet", *OUTPUTS)


def build_model(name: str = "unet", *, num_classes: int,
                init_features: int | None = None, seed: int = 0,
                checkpoint: str | None = None, device) -> torch.nn.Module:
    """The model to serve: random init from ``seed``, or the weights of a
    ``checkpoint`` (``training/checkpoint.model_state_dict``: a
    ``train --checkpoint-dir`` file, a ``save_model`` file or a bare model
    state dict). ``init_features`` sets the width (ReLayNet's
    ``num_filters``); ``None`` takes the model's default (32 for the U-Net,
    64 for ReLayNet)."""
    if name not in WIDTH_ARGS:
        raise ValueError(f"model {name!r}: the served models are "
                         f"{', '.join(WIDTH_ARGS)}")
    width = {} if init_features is None else {WIDTH_ARGS[name]: init_features}
    model = get_model(name, in_channels=1, num_classes=num_classes,
                      seed=seed, **width)
    if checkpoint:
        model.load_state_dict(model_state_dict(checkpoint))
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
    U-Net only), the model is neither folded nor calibrated. With tracing
    on (``utils/profiling``) each call is the span ``serve.forward``, its
    id the call's number, and its z-score ``serve.preprocess``."""
    if (name, quantize) not in GRAPHS:
        modes = "|".join(q for m, q in GRAPHS if m == name) or "off"
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
    calls = itertools.count()

    def forward(images: torch.Tensor) -> torch.Tensor:
        with annotate("serve.forward", next(calls)):
            with annotate("serve.preprocess"):
                x = preprocess(images)
            return graph(qparams, x, num_classes)

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
    made on the device (validation from seed 99). FourierNet and AnoGAN
    train through their own trainers, and BioNet (three outputs) through
    none: they raise ``ValueError``. Inside a process group the trainer
    trains over its data axis, every rank of the group (``local_mesh``)."""
    if args.model in OWN_TRAINERS:
        raise ValueError(
            f"train --model {args.model}: its forward is not a segmentation "
            f"map; it trains through {OWN_TRAINERS[args.model]}")
    if args.model in OUTPUTS:
        raise ValueError(
            f"train --model {args.model}: its forward returns "
            f"{OUTPUTS[args.model]}, and neither package has a loss or a "
            "trainer for it")
    device = _device(args.device)
    mesh = local_mesh() if world()[1] > 1 else None
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
        return Trainer(cfg, device, mesh), train_ds, val_ds

    def dataset(num, seed):
        height, width = cfg.data.image_size
        dcfg = SyntheticOCTConfig(height=height, width=width,
                                  num_layers=max(args.num_classes - 2, 1),
                                  seed=seed)
        return SyntheticOCTDataset(dcfg, num, cfg.data.batch_size, device)

    return (Trainer(cfg, device, mesh), dataset(cfg.data.num_train, 0),
            dataset(cfg.data.num_val, 99))


def _train_ranks(args) -> int:
    """The ranks ``train`` starts: every card where ``--device cuda`` names
    no card, the host has more than one and no process group is active;
    else 1 (this process trains)."""
    device = _device(args.device)
    if device.type != "cuda" or device.index is not None or world()[1] > 1:
        return 1
    return torch.cuda.device_count()


def _fit(args):
    """``build_training``'s trainer fitted; rank 0 logs its history.
    -> (trainer, train state)."""
    trainer, train_ds, val_ds = build_training(args)
    state = trainer.fit(train_ds, val_ds)
    if world()[0] == 0:
        logger = MetricLogger(args.log_file)
        for rec in trainer.history:
            logger.log(rec)
    return trainer, state


def _train_rank(args):
    """One rank of ``train`` over the host's cards, on this rank's card
    (``run_ranks`` set it) inside the process group. -> on rank 0 its
    trainer's config and its train state's ``state_dict()`` on the host;
    None on the others."""
    args = argparse.Namespace(**{**vars(args), "device":
                                 f"cuda:{torch.cuda.current_device()}"})
    trainer, state = _fit(args)
    if torch.distributed.get_rank():
        return None
    return trainer.cfg, tree_map(torch.Tensor.cpu, state.state_dict())


def cmd_train(args):
    """Train as ``build_training`` sets it up; -> the train state. Over k >
    1 cards it starts k ranks (``_train_ranks``) and returns rank 0's state
    rebuilt on the host (the same ``TrainState``, on the CPU)."""
    n = _train_ranks(args)
    if n == 1:
        return _fit(args)[1]
    if args.batch_size % n:
        raise SystemExit(f"train over the host's {n} cards: --batch-size "
                         f"{args.batch_size} must be a multiple of {n}")
    cfg, saved = run_ranks(_train_rank, n, args, backend="nccl")[0]
    state = Trainer(dataclasses.replace(cfg, checkpoint_dir=None),
                    "cpu").init_state()
    state.load_state_dict(saved)
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


SPATIAL_MODES = ("off", "int8")
# the models whose every operation sees a bounded window of rows, so that
# halo rows make a shard's logits the whole image's: the U-Net. FFC's FFT,
# squeeze-excitation's global pooling and whole-image attention would see
# one shard alone.
SPATIAL_MODELS = ("unet",)
# the U-Net's four 2x2 pools: a shard's height must be a multiple
SPATIAL_ROWS = 16


def _check_spatial(args) -> None:
    """``--spatial N`` takes ``--quantize off|int8``, as in JAX (the
    packed and psrp layouts shard over data, ``parallel/serving``), and
    raises for a model outside ``SPATIAL_MODELS``, whose sharded masks
    would differ from ``--spatial 1``'s."""
    if args.quantize not in SPATIAL_MODES:
        raise SystemExit(
            "--spatial supports --quantize off|int8 (the packed/psrp "
            "layouts shard over data, not space — see parallel/serving)")
    if args.model == "relaynet" and args.quantize != "off":
        raise SystemExit("--model relaynet supports --quantize int8|psrp "
                         "(single-device)")
    if args.model not in SPATIAL_MODELS:
        raise SystemExit(
            f"--spatial shards {', '.join(SPATIAL_MODELS)} only: --model "
            f"{args.model} is not known to be local in H (an FFT, a global "
            "pooling or a whole-image attention would see one shard alone)")


def _spatial_infer_rank(args):
    """One rank of ``infer --spatial N``: ``cmd_infer`` inside the process
    group; rank 0's masks."""
    preds = cmd_infer(args)
    return preds.cpu() if torch.distributed.get_rank() == 0 else None


def _run_spatial(args):
    """Start the N ranks of ``infer --spatial N`` (``parallel/launch``):
    NCCL with a card each where the host has N cards, else gloo with
    every rank on ``--device`` (two ranks share one card)."""
    device = _device(args.device)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    backend = "nccl" if device.type == "cuda" and cards >= args.spatial \
        else "gloo"
    return run_ranks(_spatial_infer_rank, args.spatial, args,
                     backend=backend)[0]


def _spatial_preds(args, trainer, images):
    """Labels of ``images`` with H sharded over the N ranks of the
    process group (``parallel.halo.spatial_shard_infer``): the float
    model or the all-int8 oracle, equal to the unsharded forward's."""
    if images.shape[1] % (SPATIAL_ROWS * args.spatial):
        raise SystemExit(f"--spatial {args.spatial}: the image height "
                         f"{images.shape[1]} must be a multiple of "
                         f"{SPATIAL_ROWS * args.spatial} (a shard takes "
                         f"the U-Net's {SPATIAL_ROWS}x pooling)")
    mesh = create_mesh(data=1, space=args.spatial)
    xs = trainer._preprocess(images.float())
    if args.quantize == "off":
        logits = spatial_shard_infer(
            lambda m, t: nhwc_logits(m, t, trainer.dtype), trainer.model,
            xs, mesh)
        return logits.argmax(-1), None
    loaded = (load_qparams(args.load_quantized, args.quantize)
              if args.load_quantized else None)
    _, calib = build_quantized_forward(
        trainer.model, args.model, args.quantize, image_size=args.image_size,
        device=trainer.device, seed=args.seed, qparams=loaded)
    logits = spatial_shard_infer(unet_int8_forward, calib["qparams"], xs,
                                 mesh)
    return logits.argmax(-1), calib


def build_eval_trainer(args, num_classes: int = 0):
    """-> (trainer, state): the model of ``infer``/``eval``'s arguments as
    the JAX CLI builds it (``--model-kwargs``, random init from ``--seed``
    or the weights of ``--checkpoint``, read by
    ``training/checkpoint.model_state_dict``), in eval mode on
    ``--device``; with ``num_classes`` classes where that is more than
    ``--num-classes``. A model whose forward is not one tensor of logits
    (AnoGAN, FourierNet, SDNet, BioNet) exits."""
    if args.model in NOT_ONE_TENSOR:
        raise SystemExit(f"--model {args.model}: infer and eval take a model "
                         "whose forward returns one tensor of logits")
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
            model_state_dict(args.checkpoint, map_location=device))
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
    probability maps (``prob_0000.txt``, ..., or the images' names).

    ``--spatial N`` shards the B-scans' height over N ranks that this
    command starts (``--quantize off|int8``); rank 0 writes the masks,
    which equal ``--spatial 1``'s."""
    spatial = getattr(args, "spatial", 1)
    if spatial > 1:
        _check_spatial(args)
        if world()[1] != spatial:
            return _run_spatial(args)
    writer = world()[0] == 0
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
        calib = None
        if spatial > 1:
            preds, calib = _spatial_preds(args, trainer, images)
        elif args.quantize == "off":
            preds = trainer.predict(state, images)
        else:
            loaded = (load_qparams(args.load_quantized, args.quantize)
                      if args.load_quantized else None)
            forward, calib = build_quantized_forward(
                trainer.model, args.model, args.quantize,
                image_size=args.image_size, device=trainer.device,
                seed=args.seed, qparams=loaded)
            preds = forward(images)
        if not writer:
            return preds
        if calib is not None and args.save_quantized:
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


def _shapes(out):
    """The shapes of a model's output: a tensor's, or a tuple's, list's or
    dict's entries', as the JAX CLI prints them."""
    if isinstance(out, torch.Tensor):
        return tuple(out.shape)
    if isinstance(out, dict):
        return {k: _shapes(v) for k, v in out.items()}
    return type(out)(_shapes(v) for v in out)


def cmd_smoke(args) -> None:
    """One forward of each ported model (``--model all``: the registry) on
    a seeded standard-normal one-channel B-scan, eval mode, random init, at
    the JAX CLI's sizes (64x64, MGU-Net's 160x160; SDNet's channels; AnoGAN
    with one output channel, its input's); prints the JAX CLI's line. A
    model that fails prints ``NAME FAIL: Type: message`` and the loop goes
    on; with ``--strict`` it raises."""
    device = _device(args.device)
    names = list_models() if args.model == "all" else [args.model]
    for name in names:
        t0 = time.time()
        size, kwargs, kw = 64, {}, {}
        num_classes = args.num_classes
        if name in ("mgunet", "mgunet_2"):  # its pools need the room
            size = 160
        if name == "sdnet":  # the JAX CLI's size and channels
            kwargs = {"img_size": size, "channels": (8, 16, 32, 64, 128)}
            kw = {"generator": torch.Generator(device=device).manual_seed(2)}
        if name == "anogan":  # D reads G's output: out == in channels
            num_classes = 1
        try:
            model = get_model(name, in_channels=1, num_classes=num_classes,
                              **kwargs).to(device)
            x = torch.from_numpy(np.random.default_rng(0).standard_normal(
                (1, 1, size, size)).astype(np.float32)).to(device)
            with torch.no_grad():
                out = model(x, **kw)
            n_params = sum(p.numel() for p in model.parameters())
            print(f"{name:16s} ok  params={n_params:>12,}  "
                  f"out={str(_shapes(out))[:80]}  ({time.time() - t0:.1f}s)")
        except Exception as e:  # noqa: BLE001 - smoke reporting
            print(f"{name:16s} FAIL: {type(e).__name__}: {e}")
            if args.strict:
                raise


def _eval_args(p: argparse.ArgumentParser) -> None:
    """The JAX CLI's common flags, and ``--device``, ``--seed`` and
    ``--checkpoint`` (the model's weights)."""
    p.add_argument("--model", default="unet", choices=list_models(),
                   help="--quantize off: any model whose forward returns "
                        "one tensor; the int8 modes: unet, relaynet")
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
                   help="the model's weights (.pt): a train --checkpoint-dir "
                        "file, a save_model file or a model state dict")


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
                   help="the model's weights (.pt): a train --checkpoint-dir "
                        "file, a save_model file or a model state dict")
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
                                     "synthetic data (fouriernet and anogan "
                                     "have their own trainers)")
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
                   help="shard the B-scans' height over N ranks started "
                        "here (--model unet, --quantize off|int8; gloo "
                        "with every rank on --device unless the host has N "
                        "cards)")
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
    m.add_argument("--strict", action="store_true",
                   help="raise on the first model that fails")
    m.set_defaults(fn=cmd_smoke)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
