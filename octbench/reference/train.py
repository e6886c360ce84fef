"""Plain reference of a training step: a model's train-mode float32
forward (its reference module's ``train_forward``), Dice + cross-entropy on
the logits, autograd, and Adam (bias-corrected, eps outside the square
root); and the first BatchNorm's batch statistics at the configuration's
compute precision (``first_bn_stats``).

Over several data-parallel ranks each rank holds a block of the global
batch's rows; BatchNorm's and the loss's sums are taken over all ranks
(``stat_sum`` and ``loss_sum``: all-reduces, the first of whose gradients
is summed over the ranks again, since each rank's rows use the statistic,
while the second's passes through, since every rank computes the same
loss from the same sums), and the gradients are summed before Adam. On one rank every sum is local.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .common import full_float32, zscore

DICE_EPS = 1e-7


class _LossSum(torch.autograd.Function):
    """Sum over the ranks; the gradient passes through unchanged: every
    rank computes the same loss from the summed values, so each rank's
    part of the sum gets the loss's own gradient."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        return g


class _StatSum(torch.autograd.Function):
    """Sum over the ranks, and the gradients summed over the ranks in the
    backward: a BatchNorm statistic is used by every rank's own rows, so
    its gradient gathers all of their contributions."""

    @staticmethod
    def forward(ctx, t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g)
        return g


def _ranked() -> bool:
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def loss_sum(t: torch.Tensor) -> torch.Tensor:
    """A loss's sum over the ranks (``t`` itself on one)."""
    return _LossSum.apply(t) if _ranked() else t


def stat_sum(t: torch.Tensor) -> torch.Tensor:
    """A BatchNorm statistic's sum over the ranks (``t`` itself on one)."""
    return _StatSum.apply(t) if _ranked() else t


def world_size() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def dice_ce(logits: torch.Tensor, labels: torch.Tensor,
            count: int) -> torch.Tensor:
    """Soft multi-class Dice loss (1 - mean per-class Dice) plus the mean
    cross-entropy, over the global batch of ``count`` pixels; ``logits``
    (N, C, H, W), ``labels`` (N, H, W) int64."""
    logp = torch.log_softmax(logits.float(), dim=1)
    onehot = torch.nn.functional.one_hot(labels, logits.shape[1]).permute(
        0, 3, 1, 2).float()
    ce = -loss_sum((logp * onehot).sum()) / count
    probs = logp.exp()
    inter = loss_sum((probs * onehot).sum(dim=(0, 2, 3)))
    denom = loss_sum(probs.sum(dim=(0, 2, 3))) + \
        loss_sum(onehot.sum(dim=(0, 2, 3)))
    dice = (2.0 * inter + DICE_EPS) / (denom + DICE_EPS)
    return (1.0 - dice.mean()) + ce


def fp8_cast(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 at a per-tensor scale (absmax to 448),
    with the gradient passing through: the control's precision."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    q = (t.detach() * (448.0 / amax)).to(torch.float8_e4m3fn).float() * \
        (amax / 448.0)
    return t + (q - t).detach()


class Adam:
    """Adam over a dict of float32 tensors: m, v, bias correction, eps
    outside the square root."""

    def __init__(self, params: dict, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / c2 ** 0.5).add_(self.eps)
            params[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(model, p: dict, batches, lr: float, cast=None):
    """Follow the program's first steps from the weights ``p`` (the BN
    running statistics included) on ``batches``: this rank's rows of each
    step's global batch, (images (n, H, W, 1) float32, labels (n, H, W)),
    on the device. ``model`` is the reference module that supplies
    ``train_forward`` and ``trainable``. -> {"loss": [each step's loss],
    "grad": {leaf: first step's gradient}, "stats": {running-statistic
    buffer: the first step's batch statistic that updates it}, "params":
    {leaf: parameters after the last step}}.
    float32 without TF32; ``cast`` rounds each conv's operands (the
    control)."""
    params = {k: v.detach().clone().float() for k, v in p.items()
              if model.trainable(k)}
    buffers = {k: v.detach().clone().float() for k, v in p.items()
               if not model.trainable(k)}
    opt = Adam(params, lr)
    out = {"loss": [], "grad": None}
    with full_float32():
        for images, labels in batches:
            x = zscore(images.float()).permute(0, 3, 1, 2)
            n, _, h, w = x.shape
            count = n * h * w * world_size()
            leaves = {k: v.requires_grad_(True) for k, v in params.items()}
            logits, stats = model.train_forward(
                {**leaves, **buffers}, x, stat_sum=stat_sum,
                ranks=world_size(), cast=cast)
            loss = dice_ce(logits, labels.long(), count)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            grads = dict(zip(leaves, grads))
            if world_size() > 1:
                for g in grads.values():
                    dist.all_reduce(g)
            for v in params.values():
                v.requires_grad_(False)
            opt.step(params, grads)
            with torch.no_grad():
                for name, (mean, var) in stats.items():
                    rm, rv = f"{name}.running_mean", f"{name}.running_var"
                    buffers[rm] = 0.9 * buffers[rm] + 0.1 * mean
                    buffers[rv] = 0.9 * buffers[rv] + 0.1 * var
            out["loss"].append(float(loss.detach()))
            if out["grad"] is None:
                out["grad"] = {k: g.detach().clone() for k, g in
                               grads.items()}
                out["stats"] = {f"{name}.running_{part}": t for name, mv
                                in stats.items()
                                for part, t in zip(("mean", "var"), mv)}
    out["params"] = params
    return out


@torch.no_grad()
def first_bn_stats(weight: torch.Tensor, images: torch.Tensor, dtype,
                   bn: str, block: int = 8) -> dict:
    """The first BatchNorm's batch statistics in the first step: the mean
    and the biased variance, over every row of the global batch ``images``
    ((N, H, W, 1) float32), of the bias-free 'same' conv ``weight`` on the
    z-scored rows, with its operands and its output rounded to ``dtype``
    (the configuration's compute precision) and every product and sum
    exact in float64. -> {"<bn>.running_mean": mean, "<bn>.running_var":
    var}, float64 on the weight's device.

    A direct function of which rows the step saw: it moves with every row
    left out, while the precision that the program states moves it by
    rounding alone."""
    kh, kw = weight.shape[-2:]
    w = weight.to(dtype).double()
    s1 = s2 = 0.0
    count = 0
    for i in range(0, images.shape[0], block):
        x = zscore(images[i:i + block].to(weight.device).float())
        x = x.permute(0, 3, 1, 2).to(dtype).double()
        y = F.conv2d(x, w, padding=(kh // 2, kw // 2)).to(dtype).double()
        s1 = s1 + y.sum(dim=(0, 2, 3))
        s2 = s2 + (y * y).sum(dim=(0, 2, 3))
        count += y.shape[0] * y.shape[2] * y.shape[3]
    mean = s1 / count
    return {f"{bn}.running_mean": mean,
            f"{bn}.running_var": s2 / count - mean * mean}
