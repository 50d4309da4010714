"""Disparity regression and hypothesis sampling.

Counterpart of the JAX package's ``ops/sampling.py``.  Per-pixel hypothesis
tensors are sample-last [B, H, W, D].  The JAX package's iterated-max top-k
and pairwise-rank sort are TPU formulations; here a stable sort computes the
same orders: top-k ties go to the lowest index, and equal hypotheses keep
their original order.  (``torch.topk`` leaves its tie order unspecified, so
it is not used.)
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

# fixed fractions on the device, made once per (fractions, type, device): a
# CUDA graph cannot capture the host-to-device copy that makes them
_FRACTIONS: Dict[tuple, torch.Tensor] = {}


def topk_soft_argmin(cost: torch.Tensor, disp_sample: torch.Tensor,
                     offset: torch.Tensor, k: int = 2
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k soft-argmin with learned offsets; cost/disp_sample/offset
    [B, H, W, D] -> (disp [B,H,W,1], topk_disp [B,H,W,k], topk_cost
    [B,H,W,k])."""
    order = torch.sort(cost, dim=-1, descending=True, stable=True).indices
    order = order[..., :k]
    topk_cost = torch.gather(cost, -1, order)
    topk_disp = torch.gather(disp_sample + offset, -1, order)
    prob = torch.softmax(topk_cost, dim=-1)
    disp = torch.sum(prob * topk_disp, dim=-1, keepdim=True)
    return disp, topk_disp, topk_cost


def soft_argmin(cost: torch.Tensor, disp_sample: torch.Tensor,
                temperature: float = 1.0, normalize: bool = True
                ) -> torch.Tensor:
    """The softmax(cost * temperature)-weighted expectation of the
    hypotheses (``cost`` itself as the weights when not ``normalize``):
    cost, disp_sample [B, H, W, D] -> [B, H, W, 1]."""
    prob = torch.softmax(cost * temperature, dim=-1) if normalize else cost
    return torch.sum(prob * disp_sample, dim=-1, keepdim=True)


def hard_argmin(cost: torch.Tensor, disp_sample: torch.Tensor
                ) -> torch.Tensor:
    """The hypothesis of the largest cost (ties to the first index, as
    ``jnp.argmax`` breaks them): [B, H, W, D] -> [B, H, W, 1]."""
    idx = torch.argmax(cost, dim=-1, keepdim=True)
    return torch.gather(disp_sample, -1, idx)


def sort_samples_with_volume(disp_sample: torch.Tensor, volume: torch.Tensor,
                             dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort hypotheses by disparity (stable) and permute the volume to match.

    disp_sample [B, H, W, D]; ``volume`` holds its D axis at ``dim``:
    [B, D, H, W, C] by default, [B, C, D, H, W] with ``dim=2``.
    """
    sorted_sample, order = torch.sort(disp_sample, dim=-1, stable=True)
    order = order.permute(0, 3, 1, 2)                        # [B, D, H, W]
    order = order[..., None] if dim == 1 else order[:, None]
    return sorted_sample, torch.gather(volume, dim, order.expand_as(volume))


def linear_disparity_samples(b: int, h: int, w: int, num_sample: int,
                             dtype=torch.float32, device=None) -> torch.Tensor:
    """Dense integer hypotheses 0..D-1 per pixel -> [B, H, W, D]."""
    return torch.arange(num_sample, dtype=dtype, device=device).view(
        1, 1, 1, -1).expand(b, h, w, num_sample)


def fractional_disparity_samples(low: torch.Tensor, high: torch.Tensor,
                                 fractions: Sequence[float] = (
                                     0.0, 3 / 8, 4 / 8, 5 / 8, 1.0)
                                 ) -> torch.Tensor:
    """Hypotheses at fixed fractions of [low, high]: [B, H, W, 1] ->
    [B, H, W, len(fractions)]."""
    key = (tuple(fractions), low.dtype, low.device)
    fr = _FRACTIONS.get(key)
    if fr is None:
        # a normal tensor even when first made under inference mode, so
        # that autograd can use it later
        with torch.inference_mode(False):
            fr = _FRACTIONS[key] = torch.tensor(fractions, dtype=low.dtype,
                                                device=low.device)
    span = torch.abs(high - low)
    base = torch.minimum(low, high)
    return base + span * fr.view(1, 1, 1, -1)
