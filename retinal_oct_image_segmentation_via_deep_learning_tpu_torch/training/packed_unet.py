"""The U-Net's training forward on the bf16 CUDA kernels (the JAX package's
``training/packed_unet.py``).

Nothing is packed on Hopper: the names ``packed_unet_apply`` and
``make_packed_train_step`` are kept so that a reader finds the counterpart.
The JAX module packs the full-resolution activations into its phase-split
row-packed layout to fill the TPU's 128 lanes; the function it computes is
the U-Net's train-mode forward, and that is what this module computes, on
NHWC bf16 activations with the float32 parameters of ``models/unet.UNet``
cast to bf16 at use.

    stage                   conv
    blk0 conv0 (stem)       library (``F.conv2d``, bf16), as JAX uses XLA
    blk0 conv1              K4 (``ops/conv_bf16.conv3x3_bf16``)
    blk1, blk7   (``mid``)  "torch": library conv (default) | "kernel": K4
    blk2..blk6  (``deep``)  "torch": library conv (default) | "kernel": K4
    blk8 conv0/conv1        K4
    transposed convs        ``F.conv_transpose2d`` + bf16 bias (the dilated
                            form of the JAX ``_ct``)
    head 1x1                bf16 matmul + bf16 bias
    loss (``fused_loss``)   K8/K9 (``ops/dice_ce``) on the NHWC logits

Every BatchNorm is ``ops/fused_bn.bn_train`` (K6 statistics). The defaults
of ``mid`` and ``deep`` are JAX's ("xla"); its TPU tile size ``tg`` has no
counterpart. With ``remat=True`` each block runs under
``torch.utils.checkpoint`` and is recomputed in the backward; each block
returns its BN statistics, and the running-stat updates (flax semantics,
0.9 * old + 0.1 * batch, biased variance) are returned by
``packed_unet_apply`` and applied once, by the caller.

``make_packed_train_step(..., mesh=)`` with a data axis of more than one
rank is JAX's step ``jit``-ted over a batch sharded on "data": each rank
takes its shard of the global batch and runs the forward, the loss and
the backward under ``parallel.collectives.data_parallel``, so K6's sums
(``ops/fused_bn``) and the loss's statistics (``training/losses`` or K8,
``ops/dice_ce``) are the global batch's; the gradients are then summed
over the ranks (``parallel.collectives.sum_gradients``). Every rank
applies the same update, and writes the same running statistics, from
the global mean and variance. The backward runs under the group too: with ``remat`` it
recomputes each block's K6 statistics there, all-reduced in the same order
on every rank.

With tracing on (``utils/profiling``) the step's phases are the spans
``step.forward`` (``packed_unet_apply``), ``step.loss``, ``step.backward``
and ``step.update`` (the gradient sum, the optimizer step and the running
statistics), each with the step's number as its id, and the rows the rank
trains on (its shard, where there is a group) count as
``input.rows_used``.
"""

from __future__ import annotations

import itertools
import os

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..models.unet import BLOCK_PREFIXES, UPCONV_NAMES
from ..ops.conv_bf16 import conv3x3_bf16
from ..ops.dice_ce import dice_ce_loss_fused
from ..ops.fused_bn import bn_train
from ..parallel.collectives import data_group, data_parallel, sum_gradients
from ..parallel.mesh import Mesh
from ..parallel.sharding import shard_batch
from ..utils.profiling import annotate, count
from .losses import dice_ce_loss

IMPLS = ("torch", "kernel")
_BF16 = torch.bfloat16


def _conv_torch(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Library 3x3 'same' conv, NHWC bf16 in and out (channels-last)."""
    w = w.to(_BF16).contiguous(memory_format=torch.channels_last)
    return F.conv2d(h.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def _conv_kernel(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """K4: (out, in, 3, 3) float32 weights -> (3, 3, in, out) bf16."""
    return conv3x3_bf16(h, w.to(_BF16).permute(2, 3, 1, 0))


_CONVS = {"torch": _conv_torch, "kernel": _conv_kernel}


def _check_impls(deep: str, mid: str) -> None:
    for name, impl in (("deep", deep), ("mid", mid)):
        if impl not in IMPLS:
            raise ValueError(f"{name}={impl!r}: expected one of {IMPLS}")


def _conv_bn_relu(h, conv: nn.Conv2d, bn: nn.BatchNorm2d, impl: str):
    y, mean, var = bn_train(_CONVS[impl](h.to(_BF16), conv.weight),
                            bn.weight, bn.bias)
    return torch.relu(y), mean, var


def _pool(h: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool on NHWC."""
    n, hh, ww, c = h.shape
    return h.reshape(n, hh // 2, 2, ww // 2, 2, c).amax(dim=(2, 4))


def _ct(h: torch.Tensor, up: nn.ConvTranspose2d) -> torch.Tensor:
    """2x2/2 transposed conv, NHWC bf16, bias added in bf16."""
    y = F.conv_transpose2d(h.to(_BF16).permute(0, 3, 1, 2),
                           up.weight.to(_BF16), stride=2)
    return y.permute(0, 2, 3, 1) + up.bias.to(_BF16)


def packed_unet_apply(model: nn.Module, x: torch.Tensor, *,
                      remat: bool = False, deep: str = "torch",
                      mid: str = "torch"):
    """Train-mode forward of ``models/unet.UNet``: (N, H, W, 1) ->
    (logits (N, H, W, num_classes) bf16, new_stats), where ``new_stats``
    maps each BatchNorm's module name to its updated (running_mean,
    running_var); ``apply_batch_stats`` writes them into the model. The
    parameters receive gradients; the running stats are not touched."""
    _check_impls(deep, mid)
    _, H, W, _ = x.shape
    if H % 16 or W % 16:
        raise ValueError(
            "packed_unet_apply needs H, W divisible by 16 (4 pools), got "
            f"{(H, W)}"
        )
    stats: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
    layers = lambda i, j: (model.get_submodule(f"{BLOCK_PREFIXES[i]}conv{j}"),
                           model.get_submodule(f"{BLOCK_PREFIXES[i]}norm{j}"))

    def record(i, j, mean, var):
        stats[f"{BLOCK_PREFIXES[i]}norm{j}"] = (mean, var)

    def block(h, i, impl):
        def body(h):
            out = []
            for j in (1, 2):
                h, mean, var = _conv_bn_relu(h, *layers(i, j), impl)
                out += [mean, var]
            return (h, *out)

        h, m1, v1, m2, v2 = (checkpoint(body, h, use_reentrant=False)
                             if remat else body(h))
        record(i, 1, m1, v1)
        record(i, 2, m2, v2)
        return h

    # encoder: the stem (1 -> f) is a library conv; blk0 conv1 runs on K4
    h, mean, var = _conv_bn_relu(x, *layers(0, 1), "torch")
    record(0, 1, mean, var)
    enc1, mean, var = _conv_bn_relu(h, *layers(0, 2), "kernel")
    record(0, 2, mean, var)
    enc2 = block(_pool(enc1), 1, mid)
    enc3 = block(_pool(enc2), 2, deep)
    enc4 = block(_pool(enc3), 3, deep)
    d = block(_pool(enc4), 4, deep)
    # decoder; the skip concats are explicit
    ups = [model.get_submodule(n) for n in UPCONV_NAMES]
    for k, (skip, impl) in enumerate(((enc4, deep), (enc3, deep),
                                      (enc2, mid), (enc1, "kernel"))):
        d = block(torch.cat([_ct(d, ups[k]), skip], dim=-1), 5 + k, impl)
    head = model.conv
    logits = (d @ head.weight[:, :, 0, 0].t().to(_BF16)
              + head.bias.to(_BF16))

    new_stats = {}
    for name, (mean, var) in stats.items():
        bn = model.get_submodule(name)
        new_stats[name] = (0.9 * bn.running_mean + 0.1 * mean,
                           0.9 * bn.running_var + 0.1 * var)
    return logits, new_stats


@torch.no_grad()
def apply_batch_stats(model: nn.Module, new_stats) -> None:
    """Write ``packed_unet_apply``'s running-stat updates into the model."""
    for name, (mean, var) in new_stats.items():
        bn = model.get_submodule(name)
        bn.running_mean.copy_(mean)
        bn.running_var.copy_(var)


def make_packed_train_step(loss_fn, class_weights=None, *, remat: bool = False,
                           deep: str = "torch", mid: str = "torch",
                           fused_loss: bool | None = None,
                           mesh: Mesh | None = None):
    """The trainer's step on ``packed_unet_apply``: ``train_step(state,
    images, labels) -> loss`` updates ``state`` (a ``TrainState`` whose
    model is a ``UNet``) in place: gradients, optimizer step, running
    stats. With a ``mesh`` whose data axis has more than one rank the step
    is data-parallel over the global batch it is given (the module
    docstring).

    ``fused_loss=True`` computes the loss on K8/K9
    (``ops/dice_ce.dice_ce_loss_fused``, the same value and gradients to
    float tolerance); it needs ``loss_fn`` to be ``dice_ce_loss``. ``None``
    reads ``OCTSEG_PACKED_FUSED_LOSS`` (``1`` turns it on), as the JAX
    package does."""
    if fused_loss is None:
        fused_loss = bool(int(os.environ.get("OCTSEG_PACKED_FUSED_LOSS",
                                             "0")))
    if fused_loss:
        if loss_fn is not dice_ce_loss:
            raise ValueError(
                "fused_loss computes dice_ce; the step's loss is "
                f"{getattr(loss_fn, '__name__', loss_fn)!r}"
            )
        loss_fn = dice_ce_loss_fused
    _check_impls(deep, mid)
    group = data_group(mesh)
    steps = itertools.count()

    def train_step(state, images, labels):
        k = next(steps)
        if group is not None:
            images, labels = shard_batch(mesh, (images, labels))
        count("input.rows_used", images.shape[0])
        state.optimizer.zero_grad(set_to_none=True)
        with data_parallel(group):
            with annotate("step.forward", k):
                logits, new_stats = packed_unet_apply(state.model, images,
                                                      remat=remat, deep=deep,
                                                      mid=mid)
            with annotate("step.loss", k):
                loss = loss_fn(logits, labels, class_weights)
            with annotate("step.backward", k):
                loss.backward()
        with annotate("step.update", k):
            if group is not None:
                sum_gradients(state.model, group)
            state.apply_gradients()
            apply_batch_stats(state.model, new_stats)
        return loss.detach()

    return train_step
