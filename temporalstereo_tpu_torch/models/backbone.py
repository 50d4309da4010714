"""TemporalStereo backbone: EfficientNetV2-S trunk + FPN with temporal
channel-memory splicing (channels-first).

Counterpart of the JAX package's ``models/backbone.py``.  Module names follow
the reference state_dict (``backbone.block{g}.{s}.{b}.conv_pw``, ``bn1``,
...).  Left and right images run through the trunk as one batch.  In every
residual InvertedResidual of a temporal model the first ``mc`` input
channels are replaced by the previous frame's slice, and the current slice
becomes the new memory.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.layers import BatchNorm, Conv2d
from ..ops.interpolate import resize_bilinear


@dataclasses.dataclass(frozen=True)
class StageSpec:
    block_type: str      # 'er' (edge residual) | 'ir' (inverted residual)
    repeats: int
    stride: int
    expand: int
    channels: int
    se_ratio: float = 0.0


# efficientnetv2_rw_s trunk in the reference's five FPN groups
V2S_GROUPS: Tuple[Tuple[StageSpec, ...], ...] = (
    (StageSpec("er", 2, 1, 1, 24),),
    (StageSpec("er", 4, 2, 4, 48),),
    (StageSpec("er", 4, 2, 4, 64),),
    (StageSpec("ir", 6, 2, 4, 128, 0.25), StageSpec("ir", 9, 1, 6, 160, 0.25)),
    (StageSpec("ir", 15, 2, 6, 272, 0.25),),
)
STEM_CHANNELS = 24

# miniature trunk with the same topology, for tests
TINY_GROUPS: Tuple[Tuple[StageSpec, ...], ...] = (
    (StageSpec("er", 1, 1, 1, 24),),
    (StageSpec("er", 1, 2, 2, 32),),
    (StageSpec("er", 1, 2, 2, 40),),
    (StageSpec("ir", 2, 2, 2, 48, 0.25), StageSpec("ir", 2, 1, 2, 56, 0.25)),
    (StageSpec("ir", 2, 2, 2, 64, 0.25),),
)


class SqueezeExcite(nn.Module):
    def __init__(self, channels: int, rd_channels: int):
        super().__init__()
        self.conv_reduce = Conv2d(channels, rd_channels, 1, bias=True)
        self.conv_expand = Conv2d(rd_channels, channels, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(F.silu(self.conv_reduce(s)))
        return x * torch.sigmoid(s)


class EdgeResidual(nn.Module):
    """Fused-MBConv: 3x3 expand conv + 1x1 project."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 expand: int = 1):
        super().__init__()
        mid = in_ch * expand
        self.conv_exp = Conv2d(in_ch, mid, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_pwl = Conv2d(mid, channels, 1, bias=False)
        self.bn2 = BatchNorm(channels)
        self.has_residual = stride == 1 and in_ch == channels

    def forward(self, x):
        y = F.silu(self.bn1(self.conv_exp(x)))
        y = self.bn2(self.conv_pwl(y))
        return x + y if self.has_residual else y


class Conv2dDW(Conv2d):
    """Depthwise 3x3 conv; its BN + SiLU are the block's ``bn2`` (the
    reference key layout keeps them beside the conv)."""

    def __init__(self, channels: int, kernel_size: int = 3, stride: int = 1):
        super().__init__(channels, channels, kernel_size, stride,
                         kernel_size // 2, bias=False, groups=channels)


class InvertedResidual(nn.Module):
    """MBConv with SE and the optional temporal channel memory."""

    def __init__(self, in_ch: int, channels: int, stride: int = 1,
                 expand: int = 4, se_ratio: float = 0.25,
                 memory_percent: float = 0.0):
        super().__init__()
        mid = in_ch * expand
        self.has_residual = stride == 1 and in_ch == channels
        self.mc = int(in_ch * memory_percent) if self.has_residual else 0
        self.conv_pw = Conv2d(in_ch, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_dw = Conv2dDW(mid, 3, stride)
        self.bn2 = BatchNorm(mid)
        self.se = (SqueezeExcite(mid, max(1, int(in_ch * se_ratio)))
                   if se_ratio > 0 else None)
        self.conv_pwl = Conv2d(mid, channels, 1, bias=False)
        self.bn3 = BatchNorm(channels)

    def forward(self, x, memory: Optional[torch.Tensor] = None,
                has_memory: Optional[bool] = None):
        """Returns (out, new_memory); new_memory is None without a splice."""
        new_memory = None
        h = x
        if self.mc > 0:
            new_memory = x[:, :self.mc]
            if memory is not None and has_memory is not False:
                h = torch.cat([memory, x[:, self.mc:]], dim=1)
        h = F.silu(self.bn1(self.conv_pw(h)))
        h = F.silu(self.bn2(self.conv_dw(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return (x + h if self.has_residual else h), new_memory


class TemporalStereoBackbone(nn.Module):
    """forward(l_img, r_img, memories, has_memory) -> (l_fms [x4, x8, x16],
    r_fms, new_memories), all [B, C, H, W].  ``memories`` is a sequence of
    [2B, mc, h, w] slices (one per residual IR block) or None."""

    def __init__(self, memory_percent: float = 0.0,
                 groups=V2S_GROUPS, out_channels=(0, 64, 128, 256, 320),
                 norm: str = "BN", activation: str = "SiLU"):
        super().__init__()
        self.memory_percent = memory_percent
        self.conv_stem = Conv2d(3, STEM_CHANNELS, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(STEM_CHANNELS)
        in_ch = STEM_CHANNELS
        for gi, group in enumerate(groups):
            stages = []
            for spec in group:
                blocks = []
                for r in range(spec.repeats):
                    stride = spec.stride if r == 0 else 1
                    if spec.block_type == "er":
                        blocks.append(EdgeResidual(in_ch, spec.channels,
                                                   stride, spec.expand))
                    else:
                        blocks.append(InvertedResidual(
                            in_ch, spec.channels, stride, spec.expand,
                            spec.se_ratio, memory_percent))
                    in_ch = spec.channels
                stages.append(nn.Sequential(*blocks))
            setattr(self, f"block{gi}", nn.Sequential(*stages))
        self.n_groups = len(groups)

        tc = tuple(g[-1].channels for g in groups)   # x2, x4, ..., x32
        oc = out_channels
        act = dict(bias=False, norm=norm, activation=activation)
        self.conv32 = Conv2d(tc[4], oc[4], 3, 1, 1, bias=False)
        self.deconv32_16 = nn.Sequential(
            Conv2d(oc[4] + tc[3], oc[3], 3, 1, 1, **act),
            Conv2d(oc[3], oc[3], 3, 1, 1, bias=False))
        self.deconv16_8 = nn.Sequential(
            Conv2d(oc[3] + tc[2], oc[2], 3, 1, 1, **act),
            Conv2d(oc[2], oc[2], 3, 1, 1, bias=False))
        self.deconv8_4 = nn.Sequential(
            Conv2d(oc[2] + tc[1], oc[1], 3, 1, 1, **act),
            Conv2d(oc[1], oc[1], 3, 1, 1, bias=False))

    def _trunk(self, x, memories, has_memory):
        new_memories: List[torch.Tensor] = []
        features = []
        x = F.silu(self.bn1(self.conv_stem(x)))
        mi = 0
        for gi in range(self.n_groups):
            for stage in getattr(self, f"block{gi}"):
                for blk in stage:
                    if isinstance(blk, EdgeResidual):
                        x = blk(x)
                        continue
                    mem = None
                    if blk.mc > 0 and memories is not None:
                        mem = memories[mi]
                        mi += 1
                    x, new_mem = blk(x, mem, has_memory)
                    if new_mem is not None:
                        new_memories.append(new_mem)
            features.append(x)
        return features, new_memories

    def forward(self, l_img: torch.Tensor, r_img: torch.Tensor,
                memories: Optional[Sequence[torch.Tensor]] = None,
                has_memory: Optional[bool] = None):
        b = l_img.shape[0]
        lr = torch.cat([l_img, r_img], dim=0)
        (_, x4, x8, x16, x32), new_memories = self._trunk(lr, memories,
                                                          has_memory)
        nchw = dict(h_axis=2, w_axis=3)
        x32 = self.conv32(x32)
        up = resize_bilinear(x32, x16.shape[2:], **nchw)
        x16 = self.deconv32_16(torch.cat([up, x16], dim=1))
        up = resize_bilinear(x16, x8.shape[2:], **nchw)
        x8 = self.deconv16_8(torch.cat([up, x8], dim=1))
        up = resize_bilinear(x8, x4.shape[2:], **nchw)
        x4 = self.deconv8_4(torch.cat([up, x4], dim=1))
        l_fms = [f[:b] for f in (x4, x8, x16)]
        r_fms = [f[b:] for f in (x4, x8, x16)]
        return l_fms, r_fms, tuple(new_memories)
