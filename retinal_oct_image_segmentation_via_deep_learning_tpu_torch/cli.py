"""Command line: ``serve`` the int8 U-Net over HTTP.

    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.cli \\
        serve --model unet --quantize psrp --image-size 512 --device cuda \\
        [--checkpoint state_dict.pt] [--seed 0]

The served forward is built by ``build_psrp_forward``: model -> BN fold ->
calibration on a seeded standard-normal batch (after the same
preprocessing the requests get) -> int8 quantization -> the served graph,
behind the per-image z-score. ``chip_smoke.py`` builds it the same way.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .inference.http_server import serve_forever
from .inference.psrp import quantize_unet_psrp, unet_psrp_forward
from .inference.quantized import calibrate_unet, fold_unet_bn
from .inference.server import ServingLoop
from .ops.preprocess import preprocess
from .registry import get_model


def build_model(name: str = "unet", *, num_classes: int,
                init_features: int = 32, seed: int = 0,
                checkpoint: str | None = None, device) -> torch.nn.Module:
    """The model to serve: random init from ``seed``, or a saved state
    dict (``torch.save(model.state_dict(), path)``)."""
    model = get_model(name, in_channels=1, num_classes=num_classes,
                      init_features=init_features, seed=seed)
    if checkpoint:
        model.load_state_dict(
            torch.load(checkpoint, map_location="cpu", weights_only=True)
        )
    return model.to(device).eval()


def build_psrp_forward(model: torch.nn.Module, *, image_size: int, device,
                       seed: int = 0):
    """-> (forward, calib): ``forward(images)`` maps (N, H, W, 1) float
    images on ``device`` to (N, H, W) int8 labels through the int8 graph;
    ``calib`` holds the folded ``layers``, the ``taps`` and the served
    ``qparams``."""
    device = torch.device(device)
    layers = fold_unet_bn(model)
    calib = np.random.default_rng(seed).standard_normal(
        (2, image_size, image_size, 1)
    ).astype(np.float32)
    with torch.inference_mode():
        taps = calibrate_unet(
            layers, [preprocess(torch.from_numpy(calib).to(device))]
        )
    f = int(layers["blk0_conv0"]["w"].shape[0])
    qparams = quantize_unet_psrp(layers, taps, init_features=f, device=device)
    num_classes = int(qparams["head"]["w_k"].shape[0])

    def forward(images: torch.Tensor) -> torch.Tensor:
        return unet_psrp_forward(qparams, preprocess(images), num_classes)

    return forward, {"layers": layers, "taps": taps, "qparams": qparams}


def cmd_serve(args) -> None:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device available")
    if args.checkpoint is None:
        print("note: no --checkpoint given; using random init from --seed")
    model = build_model(args.model, num_classes=args.num_classes,
                        init_features=args.init_features, seed=args.seed,
                        checkpoint=args.checkpoint, device=device)
    forward, _ = build_psrp_forward(model, image_size=args.image_size,
                                    device=device, seed=args.seed)
    loop = ServingLoop(forward, (args.image_size, args.image_size, 1),
                       device=device, batch_size=args.batch_size,
                       max_wait_ms=args.max_wait_ms)
    serve_forever(loop, host=args.host, port=args.port)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="octseg-torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("serve", help="HTTP serving of the int8 U-Net")
    s.add_argument("--model", default="unet")
    s.add_argument("--quantize", default="psrp", choices=["psrp"],
                   help="int8 graph on the CUDA kernels (the only mode "
                        "ported so far)")
    s.add_argument("--num-classes", type=int, default=10)
    s.add_argument("--init-features", type=int, default=32)
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
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
