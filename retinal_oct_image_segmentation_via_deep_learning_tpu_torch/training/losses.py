"""Training losses: the JAX package's ``training/losses.py``.

The segmentation losses take NHWC logits and integer (B, H, W) labels,
compute in float32 and reduce to a scalar. A label outside [0, num_classes) has an all-zero
one-hot row, as ``jax.nn.one_hot`` gives.

Under ``parallel.collectives.data_parallel`` they are the losses of the
global batch, as JAX's over a batch sharded on "data": the cross-entropy
is the global mean, and the Dice intersections and denominators are summed
over batch, space and the data group (``global_sum``, differentiable)
before the ratio.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel.collectives import data_size, global_sum

_EPS = 1e-7


def _onehot(labels: torch.Tensor, nc: int, dim: int) -> torch.Tensor:
    classes = torch.arange(nc, device=labels.device)
    shape = [1] * (labels.dim() + 1)
    shape[dim] = nc
    return (labels.unsqueeze(dim) == classes.view(shape)).float()


def _weights(class_weights, device) -> torch.Tensor:
    return torch.as_tensor(class_weights, dtype=torch.float32, device=device)


def _ce(ll: torch.Tensor, labels: torch.Tensor, class_weights) -> torch.Tensor:
    if class_weights is not None:
        w = _weights(class_weights, ll.device)[labels]
        return -global_sum(torch.sum(ll * w)) / torch.clamp_min(
            global_sum(torch.sum(w)), _EPS)
    if data_size() == 1:
        return -torch.mean(ll)
    return -global_sum(torch.sum(ll)) / (ll.numel() * data_size())


def _dice_sums(probs, onehot, axes):
    inter = global_sum(torch.sum(probs * onehot, dim=axes))
    denom = global_sum(torch.sum(probs, dim=axes)) + global_sum(
        torch.sum(onehot, dim=axes))
    return inter, denom


def _dice_term(inter, denom, class_weights) -> torch.Tensor:
    dice = (2.0 * inter + _EPS) / (denom + _EPS)
    if class_weights is not None:
        cw = _weights(class_weights, dice.device)
        return 1.0 - torch.sum(dice * cw) / torch.clamp_min(torch.sum(cw),
                                                            _EPS)
    return 1.0 - torch.mean(dice)


def softmax_cross_entropy(logits, labels, class_weights=None):
    """Mean CE over pixels; optional per-class weights."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    ll = torch.sum(logp * _onehot(labels, logits.shape[-1], -1), dim=-1)
    return _ce(ll, labels, class_weights)


def dice_loss(logits, labels, class_weights=None):
    """Soft multi-class Dice loss (1 - mean per-class soft Dice)."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    onehot = _onehot(labels, logits.shape[-1], -1)
    inter, denom = _dice_sums(probs, onehot, tuple(range(probs.dim() - 1)))
    return _dice_term(inter, denom, class_weights)


def _dice_ce_core_nchw(logits, labels, class_weights, dice_weight):
    """Dice + CE with one log-softmax and one-hot shared by both terms, on
    the class-major (B, C, H, W) view."""
    t = logits.permute(0, 3, 1, 2).float()
    logp = torch.log_softmax(t, dim=1)
    probs = torch.exp(logp)
    onehot = _onehot(labels, t.shape[1], 1)
    ce = _ce(torch.sum(logp * onehot, dim=1), labels, class_weights)
    inter, denom = _dice_sums(probs, onehot, (0, 2, 3))
    return dice_weight * _dice_term(inter, denom, class_weights) + ce


def dice_ce_loss(logits, labels, class_weights=None, dice_weight=1.0):
    """Class-weighted Dice + CE, the segmentation objective. The
    full-resolution intermediates (log-probs, probs, one-hot) are
    recomputed in the backward (``torch.utils.checkpoint`` in the role of
    ``jax.checkpoint``) instead of being kept."""
    core = partial(_dice_ce_core_nchw, class_weights=class_weights,
                   dice_weight=dice_weight)
    if not torch.is_grad_enabled() or not logits.requires_grad:
        return core(logits, labels)
    return checkpoint(core, logits, labels, use_reentrant=False)


def mse_loss(pred, target, class_weights=None):
    del class_weights  # uniform over pixels; keeps the trainer's contract
    sq = (pred.float() - target.float()) ** 2
    if data_size() == 1:
        return torch.mean(sq)
    return global_sum(torch.sum(sq)) / (sq.numel() * data_size())


def bce_with_logits(logits, targets):
    """Mean sigmoid binary cross-entropy in float32, optax's form:
    -z log_sigmoid(x) - (1 - z) log_sigmoid(-x)."""
    x, z = logits.float(), targets.float()
    return torch.mean(-z * F.logsigmoid(x) - (1.0 - z) * F.logsigmoid(-x))


def kl_divergence(mean, logvar):
    """VAE KL(q || N(0, I)), the batch mean (SDNet's modality encoder)."""
    return -0.5 * torch.mean(
        torch.sum(1 + logvar - mean ** 2 - torch.exp(logvar), dim=-1))


LOSSES = {
    "dice_ce": dice_ce_loss,
    "dice": dice_loss,
    "ce": softmax_cross_entropy,
    "mse": mse_loss,
}


def get_loss(name: str):
    return LOSSES[name]
