"""Learned upsampling: 3x3 unfold + convex combination (NHWC).

Counterpart of the JAX package's ``ops/upsample.py`` (the RAFT-style
ConvexUpsample and the UNet's 9-way mask upsample).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.spatial import active_plan, width_ratio
from .interpolate import resize_bilinear


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 neighbourhoods: [B, H, W, C] -> [B, H, W, 9, C], window index
    k = dy * 3 + dx as in ``F.unfold(kernel_size=3, padding=1)`` (inside a
    W-sharded forward, the W halo from the neighbouring ranks)."""
    b, h, w, c = x.shape
    plan = active_plan()
    if plan is None:
        pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    else:
        pad = F.pad(plan.halo(x, 2, plan.global_width(w), 1, 1),
                    (0, 0, 0, 0, 1, 1))
    return torch.stack([pad[:, dy:dy + h, dx:dx + w]
                        for dy in range(3) for dx in range(3)], dim=3)


def convex_upsample(disp: torch.Tensor, mask_logits: torch.Tensor,
                    upscale_factor: int = 2, window_size: int = 3,
                    disp_scale: float | None = None) -> torch.Tensor:
    """disp [B, H, W, 1], mask_logits [B, H, W, window^2 * up^2] ->
    [B, H*up, W*up, 1]: softmax over the window, values scaled by up."""
    assert window_size == 3, "only 3x3 windows supported"
    b, h, w, _ = disp.shape
    up = upscale_factor
    if disp_scale is None:
        disp_scale = float(up)
    mask = torch.softmax(mask_logits.reshape(b, h, w, 9, up * up), dim=3)
    patches = unfold3x3(disp * disp_scale)[..., 0]            # [B, H, W, 9]
    out = (patches[..., None] * mask).sum(dim=3)              # [B, H, W, up*up]
    out = out.reshape(b, h, w, up, up).permute(0, 1, 3, 2, 4)
    out = out.reshape(b, h * up, w * up, 1)
    plan = active_plan()
    if plan is not None:
        # each column's up columns, laid out as the plan lays out their width
        ranges = plan.part(plan.global_width(w))
        out = plan.repartition(out, 2, [(up * a, up * b) for a, b in ranges])
    return out


def mask_upsample_9(disp: torch.Tensor, mask_logits: torch.Tensor
                    ) -> torch.Tensor:
    """The UNet decoder's full-resolution upsample: disp [B, dh, dw, 1],
    mask_logits [B, H, W, 9] -> [B, H, W, 1]."""
    b, h, w, _ = mask_logits.shape
    dw = disp.shape[2]
    mask = torch.softmax(mask_logits, dim=-1)
    patches = unfold3x3(disp)[..., 0]                         # [B, dh, dw, 9]
    patches = resize_bilinear(patches * width_ratio(w, dw), (h, w))
    return torch.sum(patches * mask, dim=-1, keepdim=True)
