"""Shared aggregation blocks (channels-first: volumes [B, C, D, H, W]).

Counterpart of the JAX package's ``nn/blocks.py``: DepthwiseConv3D,
DepthwiseConvTranspose3D, ResidualBlock3D, PredictionHeads, PyramidFusion,
ConvexUpsample and the UNet guidance encoder/decoder, with the reference
implementation's module names, and the blocks off the main path:
ResidualBlock2D, BasicBlock, StereoDRNetRefinement and SPP3D.  Per-pixel
maps (disparities, costs, offsets) leave the main path's blocks in the JAX
layouts (NHWC, sample-last); StereoDRNetRefinement takes and returns
channels-first maps, as the reference's module does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.interpolate import resize_bilinear, resize_trilinear
from ..ops.upsample import convex_upsample, mask_upsample_9
from ..ops.warp import inverse_warp
from ..parallel.spatial import active_plan
from .layers import (Activation, BatchNorm, Conv2d, Conv3d, ConvTranspose2d,
                     ConvTranspose3d)

_NCDHW = (2, 3, 4)
_NCHW = dict(h_axis=2, w_axis=3)


class ResidualBlock2D(nn.Module):
    """2D hourglass with bilinear-resize skips (the 2D counterpart of
    ResidualBlock3D, with the same module names)."""

    def __init__(self, in_planes: int, norm: str = "BN",
                 activation: Activation = "SiLU"):
        super().__init__()
        c = in_planes
        act = dict(bias=False, norm=norm, activation=activation)
        noact = dict(bias=False, norm=norm, activation=None)
        self.conv1 = Conv2d(c, 2 * c, 3, 2, 1, **act)
        self.conv2 = Conv2d(2 * c, 2 * c, 3, 1, 1, **act)
        self.conv3 = Conv2d(2 * c, 2 * c, 3, 2, 1, **act)
        self.conv4 = Conv2d(2 * c, 2 * c, 3, 1, 1, **act)
        self.conv5 = ConvTranspose2d(2 * c, 2 * c, 3, 2, 1, 1, **noact)
        self.conv6 = ConvTranspose2d(2 * c, c, 3, 2, 1, 1, **noact)
        self.shortcut5 = Conv2d(2 * c, 2 * c, 1, 1, 0, **noact)
        self.shortcut6 = Conv2d(c, c, 1, 1, 0, **noact)

    def forward(self, x):
        pre = self.conv2(self.conv1(x))
        out = self.conv4(self.conv3(pre))
        out = resize_bilinear(self.conv5(out), pre.shape[2:], **_NCHW)
        out = F.silu(out + self.shortcut5(pre))
        out = resize_bilinear(self.conv6(out), x.shape[2:], **_NCHW)
        return F.silu(out + self.shortcut6(x))


class DepthwiseConv3D(nn.Module):
    """Factorised (1,k,k) + (k,1,1) 3D conv pair."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dilation: int = 1,
                 bias: bool = False, norm: str = "BN3d",
                 activation: Activation = "SiLU"):
        super().__init__()
        k, s, p, d = kernel_size, stride, padding, dilation
        args = dict(bias=bias, norm=norm, activation=activation)
        self.conv = nn.Sequential(
            Conv3d(in_planes, out_planes, (1, k, k), (1, s, s), (0, p, p),
                   (1, d, d), **args),
            Conv3d(out_planes, out_planes, (k, 1, 1), (s, 1, 1), (p, 0, 0),
                   (d, 1, 1), **args))

    def forward(self, x):
        return self.conv(x)


class DepthwiseConvTranspose3D(nn.Module):
    """Factorised transposed 3D conv pair."""

    def __init__(self, in_planes: int, out_planes: int, kernel_size: int = 3,
                 stride: int = 2, padding: int = 1, output_padding: int = 1,
                 bias: bool = False, norm: str = "BN3d",
                 activation: Activation = "SiLU"):
        super().__init__()
        k, s, p, op = kernel_size, stride, padding, output_padding
        args = dict(bias=bias, norm=norm, activation=activation)
        self.conv = nn.Sequential(
            ConvTranspose3d(in_planes, out_planes, (1, k, k), (1, s, s),
                            (0, p, p), (0, op, op), **args),
            ConvTranspose3d(out_planes, out_planes, (k, 1, 1), (s, 1, 1),
                            (p, 0, 0), (op, 0, 0), **args))

    def forward(self, x):
        return self.conv(x)


class ResidualBlock3D(nn.Module):
    """3D hourglass with trilinear-resize skips."""

    def __init__(self, in_planes: int, kernel_size: int = 3, stride: int = 2,
                 padding: int = 1, norm: str = "BN3d",
                 activation: Activation = "SiLU"):
        super().__init__()
        c, k, s, p = in_planes, kernel_size, stride, padding
        act = dict(norm=norm, activation=activation)
        noact = dict(norm=norm, activation=None)
        self.conv1 = DepthwiseConv3D(c, 2 * c, k, s, p, **act)
        self.conv2 = DepthwiseConv3D(2 * c, 2 * c, k, 1, p, **act)
        self.conv3 = DepthwiseConv3D(2 * c, 2 * c, k, s, p, **act)
        self.conv4 = DepthwiseConv3D(2 * c, 2 * c, k, 1, p, **noact)
        self.conv5 = DepthwiseConvTranspose3D(2 * c, 2 * c, k, s, p, p, **noact)
        self.conv6 = DepthwiseConvTranspose3D(2 * c, c, k, s, p, p, **noact)
        self.shortcut5 = DepthwiseConv3D(2 * c, 2 * c, k, 1, p, **noact)
        self.shortcut6 = DepthwiseConv3D(c, c, k, 1, p, **noact)

    def forward(self, x):
        out = self.conv1(x)
        pre = self.conv2(out)
        out = F.silu(self.conv4(self.conv3(pre)))
        out = resize_trilinear(self.conv5(out), pre.shape[2:], _NCDHW)
        out = F.silu(out + self.shortcut5(pre))
        out = resize_trilinear(self.conv6(out), x.shape[2:], _NCDHW)
        return F.silu(out + self.shortcut6(x))


class ConvexUpsample(nn.Module):
    """Learned convex upsample: a conv head emits per-subpixel 3x3 masks."""

    def __init__(self, in_planes: int, upscale_factor: int = 2,
                 window_size: int = 3):
        super().__init__()
        self.up, self.win = upscale_factor, window_size
        self.mask = nn.Sequential(
            Conv2d(in_planes, 64, 3, 1, 1, bias=True),
            BatchNorm(64),
            nn.SiLU(),
            Conv2d(64, window_size ** 2 * upscale_factor ** 2, 1,
                   bias=True))

    def forward(self, feat: torch.Tensor, disp: torch.Tensor,
                disp_scale: Optional[float] = None) -> torch.Tensor:
        """feat [B, C, H, W]; disp [B, H, W, 1] f32 -> [B, 2H, 2W, 1]."""
        m = self.mask(feat).permute(0, 2, 3, 1).float()
        return convex_upsample(disp, m, self.up, self.win, disp_scale)


class PredictionHeads(nn.Module):
    """Cost and offset heads: [B, C, D, H, W] -> (cost, offset), each
    sample-last [B, H, W, D]; offset = clip(tanh(x / 100)) * delta."""

    def __init__(self, in_planes: int, delta: float = 1.0, norm: str = "BN3d",
                 activation: Activation = "SiLU"):
        super().__init__()
        self.delta = delta
        c = in_planes

        def head():
            return nn.Sequential(
                Conv3d(c, c, (3, 1, 1), 1, (1, 0, 0), bias=False, norm=norm,
                       activation=activation),
                Conv3d(c, 1, (1, 3, 3), 1, (0, 1, 1), bias=False))

        self.cost_head = head()
        self.off_head = head()

    def forward(self, init_cost) -> Tuple[torch.Tensor, torch.Tensor]:
        off = self.off_head(init_cost)[:, 0].permute(0, 2, 3, 1)
        off = torch.clamp(torch.tanh(off / 100.0), -1.0, 1.0) * self.delta
        cost = self.cost_head(init_cost)[:, 0].permute(0, 2, 3, 1)
        return cost, off


class PyramidFusion(nn.Module):
    """Disparity-axis context: concat(volume, (5,1,1) conv, 5x5x5 avg and
    max pools) fused back to C channels."""

    def __init__(self, in_planes: int, norm: str = "BN3d",
                 activation: Activation = "SiLU"):
        super().__init__()
        c = in_planes
        self.conv_5x5 = Conv3d(c, c, (5, 1, 1), 1, (2, 0, 0), bias=False,
                               norm="BN3d", activation=activation)
        self.conv_fuse = DepthwiseConv3D(4 * c, c, 3, 1, 1, bias=False,
                                         norm=norm, activation=None)

    def forward(self, cost):
        fused = [cost, self.conv_5x5(cost)]
        plan = active_plan()
        if plan is not None:
            fused += plan.box_pools(cost, 5)
        elif min(cost.shape[2:]) >= 5:
            fused += [F.avg_pool3d(cost, 5, 1, 2), F.max_pool3d(cost, 5, 1, 2)]
        else:
            # torch's avg_pool3d refuses an axis shorter than its window
            # whatever the padding: pad with the zeros it would count
            fused += [F.avg_pool3d(F.pad(cost, (2,) * 6), 5, 1, 0),
                      F.max_pool3d(cost, 5, 1, 2)]
        cat = torch.cat(fused, dim=1)
        return self.conv_fuse(cat)


class UNet(nn.Module):
    """Image-guided refinement encoder/decoder (ReLU throughout)."""

    def __init__(self, out_planes: int = 48, norm: str = "BN", C: int = 32):
        super().__init__()
        r = dict(bias=False, norm=norm, activation="ReLU")
        self.conv2 = nn.Sequential(Conv2d(3, C, 3, 2, 1, **r),
                                   Conv2d(C, C, 3, 1, 1, **r))
        self.conv4 = nn.Sequential(Conv2d(C, out_planes, 3, 2, 1, **r),
                                   Conv2d(out_planes, out_planes, 3, 1, 1, **r))
        self.fuse = nn.Sequential(Conv2d(out_planes * 2, C, 3, 1, 1, **r),
                                  Conv2d(C, C, 3, 1, 1, **r))
        self.deconv4 = ConvTranspose2d(C, C, 4, 2, 1, 0, bias=True, norm=norm,
                                       activation="ReLU")
        self.concat = Conv2d(C * 2, C, 3, 1, 1, **r)
        self.deconv2 = ConvTranspose2d(C, 9, 4, 2, 1, 0, bias=True)

    def encode_one(self, im):
        spx2 = self.conv2(im)
        return spx2, self.conv4(spx2)

    def encode(self, im_left, im_right):
        return self.encode_one(im_left), self.encode_one(im_right)

    def decode(self, disp, feat, feat2x):
        """disp [B, h, w, 1] f32; feat/feat2x channels-first ->
        full-resolution [B, H, W, 1]."""
        f = self.deconv4(self.fuse(feat))
        f = self.concat(torch.cat([f, feat2x], dim=1))
        mask = self.deconv2(f).permute(0, 2, 3, 1).float()
        return mask_upsample_9(disp, mask)


class BasicBlock(nn.Module):
    """Dilated residual block: two 3x3 convs (the second without an
    activation) plus the input."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1,
                 dilation: int = 1, norm: str = "BN",
                 activation: Activation = "ReLU"):
        super().__init__()
        pad = dilation if dilation > 1 else 1
        self.conv1 = Conv2d(in_planes, out_planes, 3, stride, pad, dilation,
                            bias=False, norm=norm, activation=activation)
        self.conv2 = Conv2d(out_planes, out_planes, 3, 1, pad, dilation,
                            bias=False, norm=norm, activation=None)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class StereoDRNetRefinement(nn.Module):
    """Warp-error refinement head (an alternative to the UNet, off the main
    path): the right image warped by the disparity, its error against the
    left one, six dilated blocks and a residual on the disparity.
    disp [B, 1, H, W], images [B, 3, H, W] -> [B, 1, H, W]."""

    def __init__(self):
        super().__init__()
        C = 16
        r = dict(bias=False, norm="BN", activation="ReLU")
        self.feat_conv = Conv2d(12, C, 3, 1, 1, **r)
        self.disp_conv = Conv2d(1, C, 3, 1, 1, **r)
        self.dilated_block = nn.Sequential(*[
            BasicBlock(2 * C, 2 * C, dilation=d) for d in (1, 2, 4, 8, 1, 1)])
        self.final_conv = Conv2d(2 * C, 1, 3, 1, 1, bias=True)

    def forward(self, disp, left_image, right_image):
        nhwc = (lambda t: t.permute(0, 2, 3, 1))
        warp_left = inverse_warp(nhwc(right_image), -nhwc(disp),
                                 mode="disparity").permute(0, 3, 1, 2)
        error = torch.abs(warp_left - left_image)
        feat = self.feat_conv(torch.cat([left_image, right_image, warp_left,
                                         error], dim=1))
        x = torch.cat([feat, self.disp_conv(disp)], dim=1)
        return F.relu(disp + self.final_conv(self.dilated_block(x)))


class SPP3D(nn.Module):
    """3D spatial pyramid pooling over a cost volume [B, C, D, H, W]: per
    stride an average pool clamped to the volume (floor semantics), a
    16-channel 1x1x1 conv, a trilinear align-corners resize back; the
    branches and the input concatenated, a full 3x3x3 fuse conv and a plain
    1x1x1 projection."""

    def __init__(self, in_planes: int, strides: Tuple[int, ...] = (2, 4, 8,
                                                                     16),
                 norm: str = "BN3d", activation: Activation = "ReLU"):
        super().__init__()
        self.strides = tuple(strides)
        r = dict(bias=False, norm=norm, activation=activation)
        self.pools = nn.ModuleList([Conv3d(in_planes, 16, 1, 1, 0, **r)
                                    for _ in self.strides])
        self.fuse = nn.Sequential(
            Conv3d(in_planes + 16 * len(self.strides), in_planes, 3, 1, 1,
                   **r),
            Conv3d(in_planes, in_planes, 1, 1, 0, bias=False))

    def forward(self, cost):
        d, h, w = cost.shape[2:]
        branches = [cost]
        for stride, conv in zip(self.strides, self.pools):
            window = (min(d, stride), min(h, stride), min(w, stride))
            pooled = F.avg_pool3d(cost, window, window)
            branches.append(resize_trilinear(conv(pooled), (d, h, w),
                                             _NCDHW))
        return self.fuse(torch.cat(branches, dim=1))
