"""The multi-rank dry run (the counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``): one data-parallel train step, the
float and int8 U-Nets spatially sharded, and the int8 oracle and the w4a4
PSRP graph served data-parallel, over n ranks.

    python -m retinal_oct_image_segmentation_via_deep_learning_tpu_torch.parallel.dryrun 2 [cuda|cpu]

It runs on the card unless asked for the CPU: with n cards the ranks run
one a card over NCCL; with fewer they run over gloo, every rank on card 0.
The line it prints names the device and the backend.
"""

from __future__ import annotations

import sys

import torch

from .launch import run_ranks
from .mesh import create_mesh, world


def dryrun_multichip(n_devices: int, device: str = "cuda") -> dict:
    """Run the dry run on ``n_devices`` ranks, on ``device`` ("cuda" by
    default; "cpu" only where asked) -> rank 0's readings. Inside a
    process group of that size it runs on the calling ranks; otherwise it
    starts them (``run_ranks``): NCCL with a card a rank where the host
    has ``n_devices`` cards, else gloo with every rank on ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"dryrun_multichip(device={device!r}): no CUDA "
                           "device available (pass device='cpu' to run "
                           "on the CPU)")
    if world()[1] == n_devices:
        return _dryrun_impl(n_devices, device)
    backend = "nccl" if dev.type == "cuda" and \
        torch.cuda.device_count() >= n_devices else "gloo"
    return run_ranks(_dryrun_impl, n_devices, n_devices, device,
                     backend=backend)[0]


def _dryrun_impl(n_devices: int, device: str) -> dict:
    from ..config import DataConfig, ModelConfig, OptimConfig, TrainConfig
    from ..inference.psrp import quantize_unet_psrp, unet_psrp_forward
    from ..inference.quantized import (
        calibrate_unet,
        fold_unet_bn,
        quantize_unet,
        unet_int8_forward,
    )
    from ..models.unet import build_unet
    from ..training.trainer import Trainer, nhwc_logits
    from .halo import spatial_shard_infer
    from .serving import dp_serve, shard_batch

    backend = torch.distributed.get_backend()
    dev = torch.device(device)
    if dev.type == "cuda":  # NCCL: this rank's card; gloo: all on one
        dev = torch.device("cuda", torch.cuda.current_device()
                           if backend == "nccl" else dev.index or 0)
    # one data-parallel train step over every rank
    mesh = create_mesh(data=n_devices)
    cfg = TrainConfig(
        model=ModelConfig(name="unet", in_channels=1, num_classes=4,
                          kwargs={"init_features": 8}),
        optim=OptimConfig(learning_rate=1e-3),
        data=DataConfig(image_size=(32, 32), batch_size=n_devices),
        compute_dtype="float32",
    )
    trainer = Trainer(cfg, dev, mesh=mesh)
    state = trainer.init_state()
    g = torch.Generator().manual_seed(0)
    images = torch.randn((n_devices, 32, 32, 1), generator=g).to(dev)
    labels = torch.randint(0, 4, (n_devices, 32, 32), generator=g).to(dev)
    loss = float(trainer.train_step_fn()(state, images, labels))

    # spatial halo inference over a data x space mesh, float and int8
    space = 2 if n_devices % 2 == 0 else 1
    mesh2 = create_mesh(data=n_devices // space, space=space)
    model = state.model.eval()
    x = torch.randn((1, 32 * space, 32, 1), generator=g).to(dev)
    with torch.no_grad():
        sp = spatial_shard_infer(
            lambda m, t: nhwc_logits(m, t, torch.float32), model, x, mesh2)
        layers = fold_unet_bn(model)
        qp = quantize_unet(layers, calibrate_unet(layers, [images[:2]]))
        sp_q = spatial_shard_infer(unet_int8_forward, qp, x, mesh2)

        # data-parallel serving: the int8 oracle and the w4a4 PSRP graph
        served = dp_serve(lambda q, t: unet_int8_forward(q, t).argmax(-1),
                          mesh)(qp, images)
        m16 = build_unet(1, 4, init_features=16, device=dev)
        l16 = fold_unet_bn(m16)
        x16 = torch.randn((n_devices, 32, 32, 1), generator=g).to(dev)
        qp4 = quantize_unet_psrp(l16, calibrate_unet(l16, [x16[:1]]), 16,
                                 deep_int4=True, device=dev)
        served4 = dp_serve(lambda q, t: unet_psrp_forward(q, t, 4),
                           mesh)(qp4, x16)
        local4 = unet_psrp_forward(qp4, shard_batch(mesh, x16), 4)
    out = {"device": str(dev), "backend": backend, "dp_loss": loss, "sp_out": tuple(sp.shape),
           "dp_serve_out": tuple(served.shape),
           "sp_int8_out": tuple(sp_q.shape),
           "dp_int4_out": tuple(served4.shape),
           "dp_int4_local_equal": bool(torch.equal(
               shard_batch(mesh, served4), local4))}
    if world()[0] == 0:
        print(f"dryrun_multichip({n_devices}) ok: " +
              ", ".join(f"{k}={v}" for k, v in out.items()), flush=True)
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 2,
                     sys.argv[2] if len(sys.argv) > 2 else "cuda")
