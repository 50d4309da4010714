"""TemporalStereo network, the temporal state and its pose reprojection.

Counterpart of the JAX package's ``models/stereo.py``.  Images are
[B, H, W, 3] and disparities [B, H, W, 1] at the public functions; inside,
the network runs channels-first in its compute type.  The carried state is
a ``PrevInfo``: backbone memories [2B, mc, h, w] in the compute type, and
the geometry (cost memory, previous disparity, local map) in NHWC f32.

Local-map growth: the map starts at 0 channels and each
``update_prev_info`` emits ``min(channels + 1, LOCAL_MAP_SIZE)`` channels,
the reference's growth schedule; the shape change needs no special casing
in eager PyTorch.  A full-width start (``local_map_channels=None``) keeps
the JAX package's duplicate-fill gating by ``local_map_valid``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops.interpolate import resize_bilinear
from ..ops.softsplat import softsplat
from ..ops.warp import project_to_3d
from .aggregation import CostMemory, TemporalStereoAggregation
from .backbone import V2S_GROUPS, TemporalStereoBackbone

EXPMAX = 50.0  # metric clamp before exp()


@dataclasses.dataclass
class PrevInfo:
    """Recurrent state carried frame to frame."""
    memories: Tuple[torch.Tensor, ...]   # [2B, mc, h, w] each
    has_memory: bool
    cost_memory: CostMemory
    prev_disp: torch.Tensor              # [B, H, W, 1] f32, full resolution
    local_map: torch.Tensor              # [B, H8, W8, S] f32 (S may be 0)
    local_map_valid: bool


class TemporalStereoNet(nn.Module):
    """forward(left_image, right_image, prev) -> (outputs, new_prev).

    ``prev`` must already be warped into the current camera by
    ``update_prev_info``.  outputs["disps"] lists four [B, H, W, 1] f32
    disparities at full resolution, finest first.
    """

    def __init__(self, backbone_cfg: Dict[str, Any],
                 coarse_cfg: Dict[str, Any], fine_cfg: Dict[str, Any],
                 precise_cfg: Dict[str, Any], with_previous: bool = False,
                 use_past_cost: bool = False, local_map_size: int = 0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone_cfg = dict(backbone_cfg)
        self.coarse_cfg, self.fine_cfg = dict(coarse_cfg), dict(fine_cfg)
        self.precise_cfg = dict(precise_cfg)
        self.with_previous = with_previous
        self.use_past_cost = use_past_cost
        self.local_map_size = local_map_size
        self.dtype = dtype
        self.backbone = TemporalStereoBackbone(**backbone_cfg)
        self.aggregation = TemporalStereoAggregation(coarse_cfg, fine_cfg,
                                                     precise_cfg)

    def forward(self, left_image: torch.Tensor, right_image: torch.Tensor,
                prev: Optional[PrevInfo] = None):
        b, full_h, full_w, _ = left_image.shape
        # NHWC images -> channels-first compute type
        left = left_image.permute(0, 3, 1, 2).to(self.dtype)
        right = right_image.permute(0, 3, 1, 2).to(self.dtype)

        memories = prev.memories if prev is not None else None
        has_memory = prev.has_memory if prev is not None else None
        l_fms, r_fms, new_memories = self.backbone(left, right, memories,
                                                   has_memory)

        cost_memory = None
        local_map = None
        if prev is not None and self.use_past_cost:
            cost_memory = prev.cost_memory
        if (prev is not None and self.local_map_size > 0
                and prev.local_map.shape[-1] > 0):
            local_map = prev.local_map
            if (prev.local_map.shape[-1] >= self.local_map_size
                    and not prev.local_map_valid):
                local_map = torch.zeros_like(local_map)

        (disps, costs, samples, offs, search_ranges, new_cost_memory,
         full_disp) = self.aggregation(l_fms, r_fms, left, right,
                                       cost_memory, local_map)

        full_disps = [resize_bilinear(d * (full_w / d.shape[2]),
                                      (full_h, full_w)) for d in disps]
        outputs = {
            "disps": full_disps,
            "costs": costs,
            "offsets": offs,
            "disp_samples": samples,
            "search_ranges": search_ranges,
            "left_feats": [f.permute(0, 2, 3, 1) for f in l_fms],
            "right_feats": [f.permute(0, 2, 3, 1) for f in r_fms],
        }
        if local_map is not None:
            outputs["local_map"] = local_map

        new_prev = None
        if prev is not None:
            new_prev = PrevInfo(
                memories=new_memories,
                has_memory=True,
                cost_memory=CostMemory(
                    new_cost_memory.disp_sample.float(),
                    new_cost_memory.cost_volume.float(),
                    new_cost_memory.valid),
                # the JAX package stops the gradient here (stereo.py:137)
                prev_disp=full_disp.float().detach(),
                local_map=prev.local_map.float(),
                local_map_valid=prev.local_map_valid)
        return outputs, new_prev


def _downscale_K(K: torch.Tensor, factor: float) -> torch.Tensor:
    return torch.cat([K[:, 0:1] / factor, K[:, 1:2] / factor, K[:, 2:]],
                     dim=1)


def _splat_metric(prev_disp: torch.Tensor) -> torch.Tensor:
    """Disparity minus its global mean, clamped: nearer pixels win."""
    return torch.clamp(prev_disp - torch.mean(prev_disp), -EXPMAX, EXPMAX)


def update_prev_info(prev: PrevInfo, K: torch.Tensor, baseline: torch.Tensor,
                     T_past_to_now: torch.Tensor, full_size: Tuple[int, int],
                     use_past_cost: bool, local_map_size: int) -> PrevInfo:
    """Warp the carried state into the current camera (f32).

    K [B, 3, 3] full-resolution intrinsics, baseline [B], T_past_to_now
    [B, 4, 4].  The cost memory and the local map share the 1/8 grid, the
    rigid flow and the splat weights, so the update is one stacked
    ``project_to_3d`` and one softmax splat.
    """
    if not use_past_cost and local_map_size <= 0:
        return prev
    full_h, full_w = full_size
    K = K.float()
    bl = baseline.float().reshape(-1, 1, 1, 1)

    if use_past_cost:
        # no gradient through the carried state (JAX stereo.py:186-187)
        ms = prev.cost_memory.disp_sample.detach()
        mv = prev.cost_memory.cost_volume.detach()
        h, w = ms.shape[1:3]
        k = ms.shape[-1]
    else:
        ms = mv = None
        h, w = prev.local_map.shape[1:3]
        k = 0

    down_K = _downscale_K(K, full_w / w)
    down_inv_K = torch.linalg.inv(down_K)
    focal = down_K[:, 0, 0].reshape(-1, 1, 1, 1)
    pd = resize_bilinear(prev.prev_disp * (w / full_w), (h, w))

    lm = None
    if local_map_size > 0:
        # newest disparity in channel 0, truncated to LOCAL_MAP_SIZE
        stacked = torch.cat([pd, prev.local_map], dim=-1)[..., :local_map_size]
        if (prev.local_map.shape[-1] >= local_map_size
                and not prev.local_map_valid):
            stacked = pd.expand_as(stacked)        # duplicate-fill start
        lm = stacked

    # channel 0 = pd itself: its reprojection gives the rigid flow
    disp_stack = torch.cat([pd] + ([ms] if ms is not None else [])
                           + ([lm] if lm is not None else []), dim=-1)
    depth_stack = bl * focal / (disp_stack + 1e-5)
    outs = project_to_3d(depth_stack, down_K, down_inv_K, T_past_to_now.float())
    flow = outs["optical_flow"][:, :, :, 0, :]
    updated = bl * focal / (outs["triangular_depth"] + 1e-5)

    splat_in = []
    if use_past_cost:
        splat_in += [updated[..., 1:1 + k], mv]
    if local_map_size > 0:
        splat_in.append(updated[..., 1 + k:])
    # nothing that reaches the splat carries a gradient (JAX stereo.py:239)
    warped = softsplat(torch.cat(splat_in, dim=-1), flow, _splat_metric(pd),
                       mode="softmax")

    new_cost_memory = prev.cost_memory
    if use_past_cost:
        new_cost_memory = CostMemory(warped[..., :k], warped[..., k:2 * k],
                                     prev.cost_memory.valid)
    new_local_map, new_valid = prev.local_map, prev.local_map_valid
    if local_map_size > 0:
        new_local_map, new_valid = warped[..., 2 * k:], True
    return PrevInfo(memories=prev.memories, has_memory=prev.has_memory,
                    cost_memory=new_cost_memory, prev_disp=prev.prev_disp,
                    local_map=new_local_map, local_map_valid=new_valid)


def init_prev_info(model: TemporalStereoNet, batch_size: int,
                   full_size: Tuple[int, int],
                   memory_shapes: Tuple[Tuple[int, ...], ...], topk: int,
                   dtype: Optional[torch.dtype] = None,
                   local_map_channels: Optional[int] = None,
                   device=None) -> PrevInfo:
    """Zero state.  ``dtype`` is the compute type of the backbone memories
    (default: the model's); geometry is f32.  ``local_map_channels`` 0
    starts the exact growth schedule; None keeps a full-width map gated by
    ``local_map_valid`` (duplicate-fill)."""
    dtype = dtype or model.dtype
    if device is None:
        device = next(model.parameters()).device
    full_h, full_w = full_size
    h8, w8 = full_h // 8, full_w // 8
    if local_map_channels is None:
        local_map_channels = max(model.local_map_size, 1)
    memories = tuple(torch.zeros((2 * batch_size, mc, h, w), dtype=dtype,
                                 device=device)
                     for h, w, mc in memory_shapes)
    return PrevInfo(
        memories=memories,
        has_memory=False,
        cost_memory=CostMemory.zeros(batch_size, h8, w8, topk, torch.float32,
                                     device),
        prev_disp=torch.zeros((batch_size, full_h, full_w, 1), device=device),
        local_map=torch.zeros((batch_size, h8, w8, local_map_channels),
                              device=device),
        local_map_valid=False)


def backbone_memory_shapes(backbone_cfg: Dict[str, Any],
                           full_size: Tuple[int, int]
                           ) -> Tuple[Tuple[int, int, int], ...]:
    """(h, w, mc) of each backbone channel memory at an input size."""
    mp = backbone_cfg.get("memory_percent", 0.0)
    groups = backbone_cfg.get("groups", V2S_GROUPS)
    if mp <= 0:
        return tuple()
    full_h, full_w = full_size
    shapes = []
    stride, ch = 2, 24                                     # after the stem
    for group in groups:
        for spec in group:
            for r in range(spec.repeats):
                s = spec.stride if r == 0 else 1
                stride *= s
                if spec.block_type == "ir" and s == 1 and ch == spec.channels:
                    shapes.append((full_h // stride, full_w // stride,
                                   int(ch * mp)))
                ch = spec.channels
    return tuple(shapes)
