"""EfficientNetV2-S trunk and FPN with the temporal channel memory
(channels-first), named as the measured program's state_dict."""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm, Conv2d
from .ops import resize_bilinear

STEM = 24
# (block type, repeats, stride, expand, channels, SE ratio) of each stage,
# in the five FPN groups: efficientnetv2_rw_s, and a miniature with its
# topology for the CPU tests
V2S = ((("er", 2, 1, 1, 24, 0.0),), (("er", 4, 2, 4, 48, 0.0),),
       (("er", 4, 2, 4, 64, 0.0),),
       (("ir", 6, 2, 4, 128, 0.25), ("ir", 9, 1, 6, 160, 0.25)),
       (("ir", 15, 2, 6, 272, 0.25),))
TINY = ((("er", 1, 1, 1, 24, 0.0),), (("er", 1, 2, 2, 32, 0.0),),
        (("er", 1, 2, 2, 40, 0.0),),
        (("ir", 2, 2, 2, 48, 0.25), ("ir", 2, 1, 2, 56, 0.25)),
        (("ir", 2, 2, 2, 64, 0.25),))
VARIANTS = {"v2s": (V2S, (0, 64, 128, 256, 320)),
            "tiny": (TINY, (0, 64, 128, 256, 96))}


class SqueezeExcite(nn.Module):
    def __init__(self, c, rd):
        super().__init__()
        self.conv_reduce = Conv2d(c, rd, 1, bias=True)
        self.conv_expand = Conv2d(rd, c, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv_expand(F.silu(self.conv_reduce(s))))


class EdgeResidual(nn.Module):
    def __init__(self, cin, cout, stride, expand):
        super().__init__()
        mid = cin * expand
        self.conv_exp = Conv2d(cin, mid, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_pwl = Conv2d(mid, cout, 1, bias=False)
        self.bn2 = BatchNorm(cout)
        self.has_residual = stride == 1 and cin == cout

    def forward(self, x):
        y = self.bn2(self.conv_pwl(F.silu(self.bn1(self.conv_exp(x)))))
        return x + y if self.has_residual else y


class InvertedResidual(nn.Module):
    """MBConv with SE; in a residual block the first ``mc`` input channels
    are swapped for the previous frame's, and the current ones are the new
    memory."""

    def __init__(self, cin, cout, stride, expand, se_ratio, memory_percent):
        super().__init__()
        mid = cin * expand
        self.has_residual = stride == 1 and cin == cout
        self.mc = int(cin * memory_percent) if self.has_residual else 0
        self.conv_pw = Conv2d(cin, mid, 1, bias=False)
        self.bn1 = BatchNorm(mid)
        self.conv_dw = Conv2d(mid, mid, 3, stride, 1, bias=False, groups=mid)
        self.bn2 = BatchNorm(mid)
        self.se = (SqueezeExcite(mid, max(1, int(cin * se_ratio)))
                   if se_ratio > 0 else None)
        self.conv_pwl = Conv2d(mid, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout)

    def forward(self, x, memory, has_memory):
        new_memory, h = None, x
        if self.mc > 0:
            new_memory = x[:, :self.mc]
            if memory is not None and has_memory:
                h = torch.cat([memory, x[:, self.mc:]], dim=1)
        h = F.silu(self.bn1(self.conv_pw(h)))
        h = F.silu(self.bn2(self.conv_dw(h)))
        if self.se is not None:
            h = self.se(h)
        h = self.bn3(self.conv_pwl(h))
        return (x + h if self.has_residual else h), new_memory


class Backbone(nn.Module):
    """(left, right, memories, has_memory) -> (left features at 1/4, 1/8,
    1/16, right ones, new memories); both views run as one batch."""

    def __init__(self, variant="v2s", memory_percent=0.0, norm="BN",
                 activation="SiLU"):
        super().__init__()
        groups, oc = VARIANTS[variant]
        self.conv_stem = Conv2d(3, STEM, 3, 2, 1, bias=False)
        self.bn1 = BatchNorm(STEM)
        cin = STEM
        for gi, group in enumerate(groups):
            stages = []
            for kind, repeats, stride, expand, cout, se in group:
                blocks = []
                for r in range(repeats):
                    s = stride if r == 0 else 1
                    blocks.append(
                        EdgeResidual(cin, cout, s, expand) if kind == "er"
                        else InvertedResidual(cin, cout, s, expand, se,
                                              memory_percent))
                    cin = cout
                stages.append(nn.Sequential(*blocks))
            setattr(self, f"block{gi}", nn.Sequential(*stages))
        self.n_groups = len(groups)
        tc = tuple(g[-1][4] for g in groups)
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

    def forward(self, left, right, memories: Optional[Sequence[torch.Tensor]],
                has_memory: bool):
        b = left.shape[0]
        x = F.silu(self.bn1(self.conv_stem(torch.cat([left, right], 0))))
        feats: List[torch.Tensor] = []
        new_memories: List[torch.Tensor] = []
        mi = 0
        for gi in range(self.n_groups):
            for stage in getattr(self, f"block{gi}"):
                for blk in stage:
                    if isinstance(blk, EdgeResidual):
                        x = blk(x)
                        continue
                    mem = None
                    if blk.mc > 0 and memories is not None:
                        mem, mi = memories[mi], mi + 1
                    x, new = blk(x, mem, has_memory)
                    if new is not None:
                        new_memories.append(new)
            feats.append(x)
        _, x4, x8, x16, x32 = feats
        nchw = dict(h_axis=2, w_axis=3)
        x32 = self.conv32(x32)
        x16 = self.deconv32_16(torch.cat(
            [resize_bilinear(x32, x16.shape[2:], **nchw), x16], 1))
        x8 = self.deconv16_8(torch.cat(
            [resize_bilinear(x16, x8.shape[2:], **nchw), x8], 1))
        x4 = self.deconv8_4(torch.cat(
            [resize_bilinear(x8, x4.shape[2:], **nchw), x4], 1))
        return ([f[:b] for f in (x4, x8, x16)], [f[b:] for f in (x4, x8, x16)],
                tuple(new_memories))


def memory_shapes(variant: str, memory_percent: float, h: int, w: int
                  ) -> Tuple[Tuple[int, int, int], ...]:
    """(h, w, channels) of each memory slice at an input size."""
    if memory_percent <= 0:
        return ()
    shapes, stride, ch = [], 2, STEM
    for group in VARIANTS[variant][0]:
        for kind, repeats, s0, _, cout, _ in group:
            for r in range(repeats):
                s = s0 if r == 0 else 1
                stride *= s
                if kind == "ir" and s == 1 and ch == cout:
                    shapes.append((h // stride, w // stride,
                                   int(ch * memory_percent)))
                ch = cout
    return tuple(shapes)
