"""Numeric sanitizers (the JAX package's ``utils/debug.py``).

- ``nan_debugging()``: while active, every op whose floating output holds
  a NaN raises ``FloatingPointError`` naming the op, in the forward and in
  the backward, as JAX's ``jax_debug_nans`` does. Torch's anomaly mode
  checks only the backward, so this is a ``TorchDispatchMode`` that looks
  at each op's outputs (a device sync an op: a debugging tool).
- ``assert_finite(tree, name)``: a host-side check for epoch boundaries or
  checkpoint time.
- ``find_nonfinite(tree)``: the state-dict paths of non-finite tensors.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class _NaNCheck(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.is_floating_point() and \
                    bool(torch.isnan(t).any()):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debugging(enabled: bool = True):
    if not enabled:
        yield
        return
    with _NaNCheck():
        yield


def _leaves(tree, path=""):
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}.{k}" if path else str(k))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}.{i}" if path else str(i))


def find_nonfinite(tree) -> list[str]:
    """Paths ("encoder1.enc1conv1.weight", "0.b") of the floating tensors
    of a module's state dict or a (nested) dict or list holding any
    non-finite value."""
    return [path for path, t in _leaves(tree)
            if t.is_floating_point() and not bool(torch.isfinite(t).all())]


def assert_finite(tree, name: str = "tree") -> None:
    bad = find_nonfinite(tree)
    if bad:
        raise FloatingPointError(
            f"non-finite values in {name}: {', '.join(bad[:10])}"
            + ("..." if len(bad) > 10 else ""))
