"""Wasserstein-style distribution loss on the cost volumes.

Counterpart of the JAX package's ``losses/wasserstein.py``: per level,
``mean over pixels of sum_D (softmax(cost) + 0.25) * |sample + offset - gt|``
over the valid pixels, with the ground-truth rescale and mask of the
smooth-L1 loss.  Layout: sample-last [B, H, W, D].  The terms are computed
in f32 whatever the compute type of the cost volume.
"""
from __future__ import annotations

from typing import Dict, Sequence, Union

import torch

from .smooth_l1 import _rescale_gt


class WassersteinDistanceLoss:
    def __init__(self, max_disp: int = 192, start_disp: int = 0,
                 global_weight: float = 1.0,
                 weights: Union[Sequence[float], None] = None,
                 sparse: bool = False):
        self.max_disp = max_disp
        self.start_disp = start_disp
        self.global_weight = global_weight
        self.weights = weights
        self.sparse = sparse

    @classmethod
    def from_config(cls, node) -> "WassersteinDistanceLoss":
        return cls(max_disp=node.get("MAX_DISP", 192),
                   start_disp=node.get("START_DISP", 0),
                   global_weight=node.get("GLOBAL_WEIGHT", 1.0),
                   weights=node.get("WEIGHTS", None),
                   sparse=node.get("SPARSE", False))

    def loss_per_level(self, cost: torch.Tensor, offset: torch.Tensor,
                       disp_sample: torch.Tensor, gt: torch.Tensor
                       ) -> torch.Tensor:
        h, w = cost.shape[1:3]
        prob = torch.softmax(cost.float(), dim=-1)
        scaled_gt, scale = _rescale_gt(gt, h, w, self.sparse)
        maskf = ((scaled_gt > self.start_disp)
                 & (scaled_gt < self.max_disp / scale)).float()
        dist = torch.abs(offset.float() + disp_sample - scaled_gt)
        war = ((prob + 0.25) * dist * maskf).sum(dim=-1).mean()
        fallback = (prob * dist * maskf).sum(dim=-1).mean()
        return torch.where(maskf.sum() >= 1.0, war, fallback)

    def __call__(self, costs, offsets, disp_samples, gt: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
        if not isinstance(costs, (list, tuple)):
            costs = [costs]
        if not isinstance(offsets, (list, tuple)):
            offsets = [offsets]
        if not isinstance(disp_samples, (list, tuple)):
            disp_samples = [disp_samples] * len(costs)
        if len(costs) != len(offsets):
            raise ValueError(f"{len(costs)} cost volumes but {len(offsets)} "
                             "offset maps")
        weights = list(self.weights or [1.0])
        while len(weights) < len(costs):
            weights.append(weights[-1])
        out = {}
        for i, (c, o, s) in enumerate(zip(costs, offsets, disp_samples)):
            if not c.shape == o.shape == s.shape:
                raise ValueError(f"level {i}: cost {tuple(c.shape)}, offset "
                                 f"{tuple(o.shape)} and samples "
                                 f"{tuple(s.shape)} differ")
            out[f"wars_loss_lvl{i}"] = (weights[i] * self.global_weight
                                        * self.loss_per_level(c, o, s, gt))
        return out
