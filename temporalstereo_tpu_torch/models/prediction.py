"""Disparity prediction heads selected by ``MODEL.PREDICTION``.

Counterpart of the JAX package's ``models/prediction.py``: thin modules
over ``ops/sampling.py``, registered in ``PREDICTION_REGISTRY`` so that
``build_prediction(cfg)`` picks one by ``MODEL.PREDICTION.NAME``.  Both take
cost and disp_sample [B, H, W, D] and return [B, H, W, 1].
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..config import ConfigNode
from ..ops.sampling import hard_argmin, soft_argmin
from ..utils.registry import PREDICTION_REGISTRY


@PREDICTION_REGISTRY.register(name="SOFTARGMIN")
class SoftArgmin(nn.Module):
    """The softmax(cost * temperature) expectation of the hypotheses."""

    def __init__(self, temperature: float = 1.0, normalize: bool = True):
        super().__init__()
        self.temperature, self.normalize = temperature, normalize

    def forward(self, cost: torch.Tensor, disp_sample: torch.Tensor
                ) -> torch.Tensor:
        return soft_argmin(cost, disp_sample, self.temperature,
                           self.normalize)

    @classmethod
    def from_config(cls, cfg: ConfigNode) -> "SoftArgmin":
        node = cfg.MODEL.PREDICTION
        return cls(temperature=node.get("TEMPERATURE", 1.0),
                   normalize=node.get("NORMALIZE", True))


@PREDICTION_REGISTRY.register(name="ARGMIN")
class Argmin(nn.Module):
    """The hypothesis of the largest cost."""

    def forward(self, cost: torch.Tensor, disp_sample: torch.Tensor
                ) -> torch.Tensor:
        return hard_argmin(cost, disp_sample)

    @classmethod
    def from_config(cls, cfg: ConfigNode) -> "Argmin":
        return cls()


def build_prediction(cfg: ConfigNode) -> nn.Module:
    """The head ``MODEL.PREDICTION.NAME`` names (SOFTARGMIN by default)."""
    name = cfg.MODEL.PREDICTION.get("NAME", "SOFTARGMIN")
    return PREDICTION_REGISTRY.get(name).from_config(cfg)
