"""Blocks of the aggregation (volumes [B, C, D, H, W]), with the module
names of the measured program's state_dict."""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (BatchNorm, Conv2d, Conv3d, ConvTranspose2d,
                     ConvTranspose3d)
from .ops import convex_upsample, mask_upsample_9, resize_trilinear

_NCDHW = (2, 3, 4)


class DepthwiseConv3D(nn.Module):
    """(1,k,k) then (k,1,1) 3D convolutions."""

    def __init__(self, cin, cout, k=3, s=1, p=1, d=1, bias=False,
                 norm="BN3d", activation="SiLU"):
        super().__init__()
        args = dict(bias=bias, norm=norm, activation=activation)
        self.conv = nn.Sequential(
            Conv3d(cin, cout, (1, k, k), (1, s, s), (0, p, p), (1, d, d),
                   **args),
            Conv3d(cout, cout, (k, 1, 1), (s, 1, 1), (p, 0, 0), (d, 1, 1),
                   **args))

    def forward(self, x):
        return self.conv(x)


class DepthwiseConvTranspose3D(nn.Module):
    def __init__(self, cin, cout, k=3, s=2, p=1, op=1, bias=False,
                 norm="BN3d", activation="SiLU"):
        super().__init__()
        args = dict(bias=bias, norm=norm, activation=activation)
        self.conv = nn.Sequential(
            ConvTranspose3d(cin, cout, (1, k, k), (1, s, s), (0, p, p),
                            (0, op, op), **args),
            ConvTranspose3d(cout, cout, (k, 1, 1), (s, 1, 1), (p, 0, 0),
                            (op, 0, 0), **args))

    def forward(self, x):
        return self.conv(x)


class ResidualBlock3D(nn.Module):
    """3D hourglass with trilinear-resize skips."""

    def __init__(self, c, k=3, s=2, p=1, norm="BN3d", activation="SiLU"):
        super().__init__()
        act = dict(norm=norm, activation=activation)
        noact = dict(norm=norm, activation=None)
        self.conv1 = DepthwiseConv3D(c, 2 * c, k, s, p, **act)
        self.conv2 = DepthwiseConv3D(2 * c, 2 * c, k, 1, p, **act)
        self.conv3 = DepthwiseConv3D(2 * c, 2 * c, k, s, p, **act)
        self.conv4 = DepthwiseConv3D(2 * c, 2 * c, k, 1, p, **noact)
        self.conv5 = DepthwiseConvTranspose3D(2 * c, 2 * c, k, s, p, p,
                                              **noact)
        self.conv6 = DepthwiseConvTranspose3D(2 * c, c, k, s, p, p, **noact)
        self.shortcut5 = DepthwiseConv3D(2 * c, 2 * c, k, 1, p, **noact)
        self.shortcut6 = DepthwiseConv3D(c, c, k, 1, p, **noact)

    def forward(self, x):
        pre = self.conv2(self.conv1(x))
        out = F.silu(self.conv4(self.conv3(pre)))
        out = resize_trilinear(self.conv5(out), pre.shape[2:], _NCDHW)
        out = F.silu(out + self.shortcut5(pre))
        out = resize_trilinear(self.conv6(out), x.shape[2:], _NCDHW)
        return F.silu(out + self.shortcut6(x))


class ConvexUpsample(nn.Module):
    def __init__(self, cin, up=2):
        super().__init__()
        self.up = up
        self.mask = nn.Sequential(
            Conv2d(cin, 64, 3, 1, 1, bias=True), BatchNorm(64), nn.SiLU(),
            Conv2d(64, 9 * up * up, 1, bias=True))

    def forward(self, feat, disp):
        return convex_upsample(disp, self.mask(feat).permute(0, 2, 3, 1),
                               self.up)


class PredictionHeads(nn.Module):
    """(cost, offset) [B, H, W, D] of a volume; offset = tanh(x / 100) *
    delta."""

    def __init__(self, c, delta=1.0, norm="BN3d", activation="SiLU"):
        super().__init__()
        self.delta = delta

        def head():
            return nn.Sequential(
                Conv3d(c, c, (3, 1, 1), 1, (1, 0, 0), bias=False, norm=norm,
                       activation=activation),
                Conv3d(c, 1, (1, 3, 3), 1, (0, 1, 1), bias=False))

        self.cost_head = head()
        self.off_head = head()

    def forward(self, v):
        off = self.off_head(v)[:, 0].permute(0, 2, 3, 1)
        off = torch.clamp(torch.tanh(off / 100.0), -1.0, 1.0) * self.delta
        return self.cost_head(v)[:, 0].permute(0, 2, 3, 1), off


class PyramidFusion(nn.Module):
    """concat(volume, (5,1,1) conv, 5x5x5 average and max pools) fused to C
    channels."""

    def __init__(self, c, norm="BN3d", activation="SiLU"):
        super().__init__()
        self.conv_5x5 = Conv3d(c, c, (5, 1, 1), 1, (2, 0, 0), bias=False,
                               norm="BN3d", activation=activation)
        self.conv_fuse = DepthwiseConv3D(4 * c, c, 3, 1, 1, bias=False,
                                         norm=norm, activation=None)

    def forward(self, cost):
        # the average pool counts the zero padding (count_include_pad)
        avg = F.avg_pool3d(F.pad(cost, (2,) * 6), 5, 1, 0)
        mx = F.max_pool3d(cost, 5, 1, 2)
        return self.conv_fuse(torch.cat([cost, self.conv_5x5(cost), avg, mx],
                                        dim=1))


class UNet(nn.Module):
    """Image guidance: encoder of each image, decoder to the full-resolution
    9-way upsample mask (ReLU throughout)."""

    def __init__(self, out_planes=48, norm="BN", C=32):
        super().__init__()
        r = dict(bias=False, norm=norm, activation="ReLU")
        self.conv2 = nn.Sequential(Conv2d(3, C, 3, 2, 1, **r),
                                   Conv2d(C, C, 3, 1, 1, **r))
        self.conv4 = nn.Sequential(Conv2d(C, out_planes, 3, 2, 1, **r),
                                   Conv2d(out_planes, out_planes, 3, 1, 1,
                                          **r))
        self.fuse = nn.Sequential(Conv2d(out_planes * 2, C, 3, 1, 1, **r),
                                  Conv2d(C, C, 3, 1, 1, **r))
        self.deconv4 = ConvTranspose2d(C, C, 4, 2, 1, 0, bias=True, norm=norm,
                                       activation="ReLU")
        self.concat = Conv2d(C * 2, C, 3, 1, 1, **r)
        self.deconv2 = ConvTranspose2d(C, 9, 4, 2, 1, 0, bias=True)

    def encode_one(self, im):
        spx2 = self.conv2(im)
        return spx2, self.conv4(spx2)

    def decode(self, disp, feat, feat2x):
        f = self.deconv4(self.fuse(feat))
        f = self.concat(torch.cat([f, feat2x], dim=1))
        return mask_upsample_9(disp, self.deconv2(f).permute(0, 2, 3, 1))
