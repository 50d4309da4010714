"""Coarse-to-fine cost aggregation with temporal memory fusion.

Counterpart of the JAX package's ``models/aggregation.py``: coarse @1/16
(dense 12 samples), fine @1/8 (5 fractional samples + local-map
hypotheses), precise @1/4 (UNet guidance, full-resolution decode, writes the
next frame's cost memory).  Features arrive channels-first and go to the
cost constructor as NHWC; volumes are [B, C, D, H, W] in the compute type;
hypotheses, disparities and the cost memory are f32 and sample-last
[B, H, W, D] in every precision.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..nn.blocks import (ConvexUpsample, DepthwiseConv3D, PredictionHeads,
                         PyramidFusion, ResidualBlock3D, UNet)
from ..nn.layers import Conv3d
from ..ops.cost import block_cost
from ..ops.interpolate import resize_bilinear
from ..ops.sampling import (fractional_disparity_samples,
                            linear_disparity_samples,
                            sort_samples_with_volume, topk_soft_argmin)
from ..utils.registry import AGGREGATION_REGISTRY


@dataclasses.dataclass
class CostMemory:
    """Warped cost memory carried between frames: disp_sample / cost_volume
    [B, H8, W8, topk] f32.  ``valid`` False makes both read as zeros."""
    disp_sample: torch.Tensor
    cost_volume: torch.Tensor
    valid: bool

    @staticmethod
    def zeros(b: int, h8: int, w8: int, topk: int, dtype=torch.float32,
              device=None) -> "CostMemory":
        z = torch.zeros((b, h8, w8, topk), dtype=dtype, device=device)
        return CostMemory(z, torch.zeros_like(z), False)

    def gated(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.valid:
            return self.disp_sample, self.cost_volume
        return (torch.zeros_like(self.disp_sample),
                torch.zeros_like(self.cost_volume))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _volume(raw_cost: torch.Tensor) -> torch.Tensor:
    # [B, D, H, W, C] from the cost constructor -> [B, C, D, H, W] for Conv3d
    return raw_cost.permute(0, 4, 1, 2, 3)


def _fuse_memory(init_cost: torch.Tensor, disp_sample: torch.Tensor,
                 memory_sample: torch.Tensor, memory_volume_raw: torch.Tensor,
                 past_conv: Conv3d):
    """Embed the warped memory costs with past_conv, append them as extra
    hypotheses, and re-sort by disparity.  memory_volume_raw [B, H, W, topk]
    -> [B, 1, topk, H, W] -> past_conv -> [B, C, topk, H, W]."""
    vol = memory_volume_raw.permute(0, 3, 1, 2)[:, None].to(init_cost.dtype)
    init_cost = torch.cat([init_cost, past_conv(vol)], dim=2)
    disp_sample = torch.cat([disp_sample, memory_sample], dim=-1)
    return sort_samples_with_volume(disp_sample, init_cost, dim=2)


def _predict(heads: PredictionHeads, init_cost, disp_sample, topk):
    cost, off = heads(init_cost)
    disp, topk_disp, topk_cost = topk_soft_argmin(cost.float(), disp_sample,
                                                  off.float(), topk)
    return cost, off, disp, topk_disp, topk_cost


class Init3D(nn.Sequential):
    """Initial volume regulariser: DepthwiseConv3D -> ResidualBlock3D ->
    dilated DepthwiseConv3D."""

    def __init__(self, in_planes: int, C: int, norm: str = "BN3d",
                 activation: Any = "SiLU"):
        super().__init__(
            DepthwiseConv3D(in_planes, C, 3, 1, 1, bias=True, norm=norm,
                            activation=activation),
            ResidualBlock3D(C, 3, 2, 1, norm=norm, activation=activation),
            DepthwiseConv3D(C, C, 3, 1, 2, dilation=2, bias=False, norm=norm,
                            activation=activation))


def _cost_planes(in_planes: int, scale: int, sparse: bool) -> int:
    return (2 if sparse else 1) * in_planes + scale * in_planes // 8


class CoarseAggregation(nn.Module):
    """Full-range aggregation @1/16 over dense integer hypotheses."""

    def __init__(self, in_planes: int, C: int, num_sample: int = 12,
                 delta: float = 1.0, block_cost_scale: int = 3,
                 topk: int = 2, spatial_fusion: bool = True,
                 norm: str = "BN3d", activation: Any = "SiLU"):
        super().__init__()
        self.num_sample, self.scale, self.topk = (num_sample,
                                                  block_cost_scale, topk)
        self.init3d = Init3D(_cost_planes(in_planes, block_cost_scale, False),
                             C, norm, activation)
        self.past_conv = Conv3d(1, C, 1, 1, 0, bias=False, norm=norm,
                                activation=activation)
        self.fuse = (PyramidFusion(C, norm, activation) if spatial_fusion
                     else None)
        self.pred_heads = PredictionHeads(C, delta, norm, activation)
        self.convex_upsample = ConvexUpsample(in_planes)

    def forward(self, left, right, memory: Optional[CostMemory]):
        b, _, h, w = left.shape
        raw = block_cost(_nhwc(left), _nhwc(right), self.num_sample,
                         self.scale)
        disp_sample = linear_disparity_samples(b, h, w, self.num_sample,
                                               torch.float32, left.device)
        init_cost = self.init3d(_volume(raw))
        if memory is None:
            ms = torch.zeros((b, h, w, self.topk), device=left.device)
            mv = torch.zeros_like(ms)
        else:
            ms, mv = memory.gated()
            mw = ms.shape[2]
            # re-grid the 1/8 memory to this 1/16 grid
            ms = resize_bilinear(ms * (w / mw), (h, w))
            mv = resize_bilinear(mv, (h, w))
        disp_sample, init_cost = _fuse_memory(init_cost, disp_sample, ms, mv,
                                              self.past_conv)
        if self.fuse is not None:
            init_cost = self.fuse(init_cost)
        cost, off, disp, _, _ = _predict(self.pred_heads, init_cost,
                                         disp_sample, self.topk)
        return self.convex_upsample(left, disp), cost, off, disp_sample


class FineAggregation(nn.Module):
    """Sparse-sample aggregation @1/8 with local-map hypotheses."""

    def __init__(self, in_planes: int, C: int, num_sample: int = 5,
                 delta: float = 1.0, block_cost_scale: int = 3,
                 topk: int = 2, spatial_fusion: bool = True,
                 norm: str = "BN3d", activation: Any = "SiLU"):
        super().__init__()
        self.scale, self.topk = block_cost_scale, topk
        # learnable in the reference but unused by its forward; kept for
        # checkpoint parity
        self.phi = nn.Parameter(torch.zeros(1))
        self.init3d = Init3D(_cost_planes(in_planes, block_cost_scale, True),
                             C, norm, activation)
        self.past_conv = Conv3d(1, C, 1, 1, 0, bias=False, norm=norm,
                                activation=activation)
        self.fuse = (PyramidFusion(C, norm, activation) if spatial_fusion
                     else None)
        self.pred_heads = PredictionHeads(C, delta, norm, activation)
        self.convex_upsample = ConvexUpsample(in_planes)

    def forward(self, left, right, low, high, memory: Optional[CostMemory],
                local_map: Optional[torch.Tensor]):
        b, _, h, w = left.shape
        disp_sample = fractional_disparity_samples(low, high)
        if local_map is not None:
            lw = local_map.shape[2]
            lm = resize_bilinear(local_map * (w / lw), (h, w))
            disp_sample = torch.cat([lm, disp_sample], dim=-1)
        raw = block_cost(_nhwc(left), _nhwc(right),
                         disp_sample.permute(0, 3, 1, 2).contiguous(),
                         self.scale)
        init_cost = self.init3d(_volume(raw))
        if memory is None:
            ms = torch.zeros((b, h, w, self.topk), device=left.device)
            mv = torch.zeros_like(ms)
        else:
            ms, mv = memory.gated()
        disp_sample, init_cost = _fuse_memory(init_cost, disp_sample, ms, mv,
                                              self.past_conv)
        if self.fuse is not None:
            init_cost = self.fuse(init_cost)
        cost, off, disp, _, _ = _predict(self.pred_heads, init_cost,
                                         disp_sample, self.topk)
        return self.convex_upsample(left, disp), cost, off, disp_sample


class PreciseAggregation(nn.Module):
    """Image-guided aggregation @1/4 + full-resolution decoder; emits the
    next frame's cost memory."""

    def __init__(self, in_planes: int, C: int, num_sample: int = 5,
                 delta: float = 1.0, block_cost_scale: int = 3,
                 topk: int = 2, norm: str = "BN3d", activation: Any = "SiLU"):
        super().__init__()
        self.scale, self.topk = block_cost_scale, topk
        self.refinement = UNet(out_planes=in_planes)
        # features = FPN (in_planes) + UNet (in_planes) channels
        self.init3d = Init3D(_cost_planes(2 * in_planes, block_cost_scale,
                                          True), C, norm, activation)
        self.pred_heads = PredictionHeads(C, delta, norm, activation)

    def forward(self, left, right, low, high, left_image, right_image):
        (spx2l, spx4l), (_, spx4r) = self.refinement.encode(left_image,
                                                            right_image)
        left = torch.cat([left, spx4l], dim=1)
        right = torch.cat([right, spx4r], dim=1)
        disp_sample = fractional_disparity_samples(low, high)
        raw = block_cost(_nhwc(left), _nhwc(right),
                         disp_sample.permute(0, 3, 1, 2).contiguous(),
                         self.scale)
        init_cost = self.init3d(_volume(raw))
        cost, off, disp, mem_sample, mem_volume = _predict(
            self.pred_heads, init_cost, disp_sample, self.topk)
        full_disp = self.refinement.decode(disp, left, spx2l)
        h, w = disp.shape[1:3]
        new_memory = CostMemory(
            disp_sample=resize_bilinear(mem_sample / 2, (h // 2, w // 2)),
            cost_volume=resize_bilinear(mem_volume, (h // 2, w // 2)),
            valid=True)
        return full_disp, disp, cost, off, disp_sample, new_memory


@AGGREGATION_REGISTRY.register(name="TEMPORALSTEREO")
class TemporalStereoAggregation(nn.Module):
    """The cascade coarse -> fine -> precise, search range disp +/- 4
    between stages; outputs are listed finest first."""

    disp_range = 4.0

    def __init__(self, coarse_cfg: Dict[str, Any], fine_cfg: Dict[str, Any],
                 precise_cfg: Dict[str, Any]):
        super().__init__()
        self.coarse = CoarseAggregation(**coarse_cfg)
        self.fine = FineAggregation(**fine_cfg)
        self.precise = PreciseAggregation(**precise_cfg)

    def forward(self, left_feats, right_feats, left_image, right_image,
                cost_memory: Optional[CostMemory] = None,
                local_map: Optional[torch.Tensor] = None):
        l4, l8, l16 = left_feats
        r4, r8, r16 = right_feats
        disps, costs, offs, samples, search_ranges = [], [], [], [], []

        disp, cost, off, sample = self.coarse(l16, r16, cost_memory)
        low, high = disp - self.disp_range, disp + self.disp_range
        for lst, v in ((disps, disp), (costs, cost), (offs, off),
                       (samples, sample)):
            lst.append(v)
        search_ranges.append({"low": low, "high": high})

        disp, cost, off, sample = self.fine(l8, r8, low, high, cost_memory,
                                            local_map)
        low, high = disp - self.disp_range, disp + self.disp_range
        for lst, v in ((disps, disp), (costs, cost), (offs, off),
                       (samples, sample)):
            lst.append(v)
        search_ranges.append({"low": low, "high": high})

        full_disp, disp, cost, off, sample, new_memory = self.precise(
            l4, r4, low, high, left_image, right_image)
        disps.extend([disp, full_disp])
        costs.append(cost)
        offs.append(off)
        samples.append(sample)
        return (disps[::-1], costs[::-1], samples[::-1], offs[::-1],
                search_ranges[::-1], new_memory, full_disp)
