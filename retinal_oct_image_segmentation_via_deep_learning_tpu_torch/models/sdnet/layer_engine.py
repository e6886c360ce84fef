"""Layer topology engine (the JAX package's ``models/sdnet/layer_engine.py``).

The first n_classes - 1 channel maps are per-A-scan layer-boundary
distributions: the column softmax over H, the soft-argmax layer positions
and the per-column std come from one call of ``ops/column_softargmax`` (K12
on the card, its plain version on the CPU); then topology enforcement in 1-D
(a running maximum over the layers, ``cummax``) and 2-D (the recurrence
c[i] = relu(c[i] + c[i-1] - 1) over the cumulative masks, a loop over the
layer channels), and the violation terms: topology, continuity, and the
11-tap curvature (edge-padded shifted differences) against the reference's
per-layer curvature-max table.

Layout: NCHW. ``soft_anatomy`` is (B, C, H, W); positions and the
per-column terms are (B, L, W), the JAX package's (B, W, L) transposed.

There is one implementation. The JAX package chooses between XLA and its
Pallas kernel (``column_impl``) because the kernel runs only on a TPU, and
its own SDNet keeps XLA; here a CUDA tensor always reaches K12, so on the
card this SDNet runs the kernel where the JAX one ran XLA, on the same
function.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import column_softargmax as k12

# The reference's per-layer curvature-max table, 11 layers.
REFERENCE_CURV_MAX = np.array(
    [1.2261, 1.1558, 1.1161, 1.1195, 2.7202, 2.3714, 1.7055, 3.2717,
     2.6716, 5.0418, 0.4293],
    np.float32,
)


def relu(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) with the JAX package's gradient (``jnp.maximum``: half at
    a tie)."""
    return torch.maximum(x, x.new_zeros(()))


class LayerEngine(nn.Module):
    def __init__(self, n_classes: int):
        super().__init__()
        self.n_classes = n_classes
        t = REFERENCE_CURV_MAX
        if self.n_layers > len(t):
            t = np.concatenate(
                [t, np.full(self.n_layers - len(t), t[-1], np.float32)])
        self.register_buffer("curv_max", torch.from_numpy(
            t[:self.n_layers].copy()), persistent=False)

    @property
    def n_layers(self) -> int:
        return self.n_classes - 1

    def topology_violations(self, positions):
        return relu(positions[:, :-1] - positions[:, 1:])

    def neighbour_diff(self, positions):
        """|adjacent-column difference| (roll, then drop column 0)."""
        return torch.abs(positions[..., :-1] - positions[..., 1:])

    def curvature_diffs(self, positions):
        """11-tap first and second derivative, edge padding."""
        p = F.pad(positions, (5, 5), mode="replicate")
        first = p[..., 10:] - p[..., :-10]
        second = p[..., 10:] - 2.0 * p[..., 5:-5] + p[..., :-10]
        curvature = second / torch.pow(1.0 + first ** 2, 1.5)
        return torch.abs(curvature) - self.curv_max[None, :, None]

    def topological_engine_1d(self, positions):
        """new[i] = max(new[i-1], pos[i]): a running max over the layers."""
        return torch.cummax(positions, dim=1).values

    def cumulative_mask(self, sm):
        upper = torch.ones_like(sm[:, :1])
        return torch.cat([upper, torch.cumsum(sm, dim=2)], dim=1)

    def topological_engine_2d(self, cum):
        """c[i] = relu(c[i] + c[i-1] - 1) for the channels from 2 on."""
        out, prev = [cum[:, 0], cum[:, 1]], cum[:, 1]
        for i in range(2, cum.shape[1]):
            prev = relu(cum[:, i] + prev - 1.0)
            out.append(prev)
        return torch.stack(out, dim=1)

    def separate_masks(self, cum):
        """m[i] = c[i] - c[i+1]; the last channel unchanged."""
        return torch.cat([cum[:, :-1] - cum[:, 1:], cum[:, -1:]], dim=1)

    def forward(self, soft_anatomy: torch.Tensor):
        """soft_anatomy (B, >= n_classes - 1, H, W) boundary logits ->
        (log_softmax, corrected positions, clean masks, losses), the
        reference's forward contract."""
        pred = soft_anatomy[:, :self.n_layers].float()
        lsm = torch.log_softmax(pred, dim=2)
        sm, positions, std = k12.column_softargmax(pred)
        losses = {
            "std_deviations": std,
            "topology_violations": self.topology_violations(positions),
            "continuity_violations": self.neighbour_diff(positions),
            "curvature_diffs": self.curvature_diffs(positions),
        }
        corrected = self.topological_engine_1d(positions)
        cum = self.topological_engine_2d(self.cumulative_mask(sm))
        return lsm, corrected, self.separate_masks(cum), losses
