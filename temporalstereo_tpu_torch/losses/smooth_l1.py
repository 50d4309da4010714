"""Multi-scale smooth-L1 disparity loss.

Counterpart of the JAX package's ``losses/smooth_l1.py``: per level, the
ground truth is rescaled to the estimate's size (values divided by the
width ratio, then max-pooled when sparse, average-pooled when dense), pixels
with ``START_DISP < gt < MAX_DISP / scale`` count, and a level without any
such pixel falls back to the masked absolute error's mean (zero), as the
reference's empty-mask branch does.  Disparities are [B, H, W, 1], f32.

With a ``mesh`` of more than one rank, the valid-pixel count and the
fallback's mean are taken over the global batch: each rank's level loss
is its own sum over the global count, so the ranks' losses sum to the loss
of the global batch and their gradients sum to its gradient.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from ..ops.interpolate import adaptive_avg_pool2d, adaptive_max_pool2d
from ..parallel.mesh import DataMesh, global_sum, mean_share


def smooth_l1(diff: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber), ``F.smooth_l1_loss`` semantics."""
    a = torch.abs(diff)
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def _rescale_gt(gt: torch.Tensor, h: int, w: int, sparse: bool):
    """gt [B, GH, GW, 1] -> (gt at (h, w) in that grid's pixels, scale)."""
    gh, gw = gt.shape[1:3]
    if (gh, gw) == (h, w):
        return gt, 1.0
    scale = gw / w
    pool = adaptive_max_pool2d if sparse else adaptive_avg_pool2d
    return pool(gt / scale, (h, w)), scale


class DispSmoothL1Loss:
    """est disparities (list of [B,H,W,1]) + gt [B,H,W,1] -> loss dict."""

    def __init__(self, max_disp: int = 192, start_disp: int = 0,
                 global_weight: float = 1.0,
                 weights: Union[Sequence[float], None] = None,
                 sparse: bool = False, mesh: Optional[DataMesh] = None):
        self.max_disp = max_disp
        self.start_disp = start_disp
        self.global_weight = global_weight
        self.weights = weights
        self.sparse = sparse
        self.mesh = mesh

    @classmethod
    def from_config(cls, node, mesh: Optional[DataMesh] = None
                    ) -> "DispSmoothL1Loss":
        return cls(max_disp=node.get("MAX_DISP", 192),
                   start_disp=node.get("START_DISP", 0),
                   global_weight=node.get("GLOBAL_WEIGHT", 1.0),
                   weights=node.get("WEIGHTS", None),
                   sparse=node.get("SPARSE", False), mesh=mesh)

    def loss_per_level(self, est: torch.Tensor, gt: torch.Tensor
                       ) -> torch.Tensor:
        h, w = est.shape[1:3]
        scaled_gt, scale = _rescale_gt(gt, h, w, self.sparse)
        maskf = ((scaled_gt > self.start_disp)
                 & (scaled_gt < self.max_disp / scale)).to(est.dtype)
        n = global_sum(maskf.sum(), self.mesh)
        masked = ((smooth_l1(est - scaled_gt) * maskf).sum()
                  / torch.clamp(n, min=1.0))
        fallback = mean_share(torch.abs(est - scaled_gt) * maskf, self.mesh)
        return torch.where(n >= 1.0, masked, fallback)

    def __call__(self, est_disps, gt: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        if not isinstance(est_disps, (list, tuple)):
            est_disps = [est_disps]
        weights = list(self.weights or [1.0])
        while len(weights) < len(est_disps):
            weights.append(weights[-1])
        return {f"l1_loss_lvl{i}": (weights[i] * self.global_weight
                                    * self.loss_per_level(est, gt))
                for i, est in enumerate(est_disps)}
