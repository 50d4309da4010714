"""Online temporal streaming: one frame at a time with carried state.

Counterpart of the JAX package's ``models/temporal.py`` (``streaming_step``,
``chained_poses``).  The JAX package decides whether to warp the state with
``lax.cond`` or a static flag; here it is a Python ``if``.
"""
from __future__ import annotations

from typing import Optional

import torch

from .stereo import PrevInfo, TemporalStereoNet, update_prev_info


def chained_poses(T_cam: torch.Tensor, inv_T: torch.Tensor) -> torch.Tensor:
    """[T, B, 4, 4] world->cam poses -> per-step T_past_to_now,
    T[t] @ inv_T[t-1] (identity for the first frame)."""
    eye = torch.eye(4, dtype=T_cam.dtype, device=T_cam.device).expand(
        T_cam.shape[1:])
    if T_cam.shape[0] == 1:
        return eye[None].clone()
    rel = torch.einsum("tbij,tbjk->tbik", T_cam[1:], inv_T[:-1])
    return torch.cat([eye[None], rel], dim=0)


@torch.inference_mode()
def streaming_step(model: TemporalStereoNet, left: torch.Tensor,
                   right: torch.Tensor, prev: Optional[PrevInfo],
                   K: torch.Tensor, baseline: torch.Tensor,
                   T_past_to_now: torch.Tensor,
                   warp: Optional[bool] = None):
    """One video frame reusing the carried state -> (outputs, new_prev).

    left/right [B, H, W, 3].  ``warp`` None warps once the state holds a
    real frame (``prev.has_memory``); True/False forces it.
    """
    if prev is not None:
        if warp is None:
            warp = prev.has_memory
        if warp:
            prev = update_prev_info(prev, K, baseline, T_past_to_now,
                                    tuple(left.shape[1:3]),
                                    model.use_past_cost, model.local_map_size)
    return model(left, right, prev)
