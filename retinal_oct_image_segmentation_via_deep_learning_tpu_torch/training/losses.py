"""Training losses: the JAX package's ``training/losses.py``.

All take NHWC logits and integer (B, H, W) labels, compute in float32 and
reduce to a scalar. A label outside [0, num_classes) has an all-zero
one-hot row, as ``jax.nn.one_hot`` gives.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import checkpoint

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
        return -torch.sum(ll * w) / torch.clamp_min(torch.sum(w), _EPS)
    return -torch.mean(ll)


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
    axes = tuple(range(probs.dim() - 1))
    inter = torch.sum(probs * onehot, dim=axes)
    denom = torch.sum(probs, dim=axes) + torch.sum(onehot, dim=axes)
    return _dice_term(inter, denom, class_weights)


def _dice_ce_core_nchw(logits, labels, class_weights, dice_weight):
    """Dice + CE with one log-softmax and one-hot shared by both terms, on
    the class-major (B, C, H, W) view."""
    t = logits.permute(0, 3, 1, 2).float()
    logp = torch.log_softmax(t, dim=1)
    probs = torch.exp(logp)
    onehot = _onehot(labels, t.shape[1], 1)
    ce = _ce(torch.sum(logp * onehot, dim=1), labels, class_weights)
    axes = (0, 2, 3)
    inter = torch.sum(probs * onehot, dim=axes)
    denom = torch.sum(probs, dim=axes) + torch.sum(onehot, dim=axes)
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
    return torch.mean((pred.float() - target.float()) ** 2)


LOSSES = {
    "dice_ce": dice_ce_loss,
    "dice": dice_loss,
    "ce": softmax_cross_entropy,
    "mse": mse_loss,
}


def get_loss(name: str):
    return LOSSES[name]
