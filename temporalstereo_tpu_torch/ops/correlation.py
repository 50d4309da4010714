"""Patch correlation and RAFT-style correlation pyramids (NHWC).

Counterpart of the JAX package's ``ops/correlation.py``: ``correlation2d``
and ``correlation1d`` (the reference's spatial_correlation_sampler
semantics), ``CorrBlock`` (the all-pairs stereo pyramid and its radius
lookup) and ``FlowCorrBlock`` (the all-pairs 2D pyramid).  Off the model's
path, as in the reference; plain PyTorch, as the JAX package computes them
outside any Pallas kernel.  The JAX package builds the patch correlation
from one roll and mask per displacement; here one im2col (``F.unfold``) of
the zero-padded second map gathers every displacement at once.
"""
from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from .interpolate import avg_pool2d
from .warp import grid_sample


def _patch_correlation(fm1: torch.Tensor, fm2: torch.Tensor,
                       window, dilation: int) -> torch.Tensor:
    """mean over C of fm1 * fm2 shifted by every (dy, dx) of a ``window``
    (rows, columns) centred on 0, zero beyond the edges: [B, H, W, C] ->
    [B, H, W, rows * columns], dy-major."""
    b, h, w, c = fm1.shape
    ky, kx = window
    pad = ((ky // 2) * dilation, (kx // 2) * dilation)
    cols = F.unfold(fm2.permute(0, 3, 1, 2), (ky, kx), dilation=dilation,
                    padding=pad)                        # [B, C*ky*kx, H*W]
    cols = cols.view(b, c, ky * kx, h * w)
    ref = fm1.permute(0, 3, 1, 2).reshape(b, c, 1, h * w)
    return (ref * cols).mean(dim=1).view(b, ky * kx, h, w).permute(0, 2, 3, 1)


def correlation2d(fm1: torch.Tensor, fm2: torch.Tensor, patch_size: int = 21,
                  dilation: int = 1) -> torch.Tensor:
    """Dense patch correlation: [B, H, W, C] x2 -> [B, H, W, patch_size**2],
    entry (dy + r) * patch_size + (dx + r) = mean over channels of
    fm1[y, x] * fm2[y + dy * dilation, x + dx * dilation]."""
    return _patch_correlation(fm1, fm2, (patch_size, patch_size), dilation)


def correlation1d(fm1: torch.Tensor, fm2: torch.Tensor, patch_size: int = 21,
                  dilation: int = 1) -> torch.Tensor:
    """Horizontal-only patch correlation (stereo) -> [B, H, W,
    patch_size]."""
    return _patch_correlation(fm1, fm2, (1, patch_size), dilation)


class CorrBlock:
    """All-pairs stereo correlation along the scanline with a pyramid over
    the target's width and a radius lookup, with the reference's
    ``grid_sample`` quirks as the JAX package pins them: level l's
    position is ``(x / 2^l + delta) * w_l / (w - 1) - 0.5`` (the full
    width's ``w - 1`` at every level), and the constant y tap scales level
    l by ``1 - 2^-(l+1)``.  fmap1/fmap2: [B, H, W, C]."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
        b, h, w, c = fmap1.shape
        corr = torch.einsum("bhic,bhjc->bhij", fmap1, fmap2) / math.sqrt(c)
        self.shape = (b, h, w)
        self.pyramid: List[torch.Tensor] = []
        lvl = corr.reshape(b * h * w, w)
        for _ in range(num_levels):
            self.pyramid.append(lvl)
            if lvl.shape[-1] >= 2:
                lvl = lvl.reshape(lvl.shape[0], -1, 2).mean(-1)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        """coords: [B, H, W] x-positions in fmap2 -> [B, H, W,
        num_levels * (2r + 1)]."""
        b, h, w = self.shape
        r = self.radius
        x0 = coords.reshape(-1, 1)
        offsets = torch.arange(-r, r + 1, dtype=coords.dtype,
                               device=coords.device)[None]
        out = []
        for lvl, corr in enumerate(self.pyramid):
            wl = corr.shape[-1]
            pos = (x0 / 2 ** lvl + offsets) * (wl / (w - 1)) - 0.5
            lo = torch.floor(pos)
            frac = pos - lo
            # the upper tap from the unclipped floor: left of 0 it is pixel 0
            lo_i = lo.long().clamp(0, wl - 1)
            hi_i = (lo.long() + 1).clamp(0, wl - 1)
            v_lo = torch.gather(corr, 1, lo_i) * ((lo >= 0)
                                                  & (lo <= wl - 1)).to(
                corr.dtype)
            v_hi = torch.gather(corr, 1, hi_i) * ((lo + 1 >= 0)
                                                  & (lo + 1 <= wl - 1)).to(
                corr.dtype)
            out.append(((1 - frac) * v_lo + frac * v_hi)
                       * (1.0 - 0.5 ** (lvl + 1)))
        return torch.cat(out, dim=-1).reshape(b, h, w, -1)


class FlowCorrBlock:
    """The all-pairs 2D pyramid with the reference's semantics as the JAX
    package pins them: the "correlation" is the Gram expression
    ``f1_i.f1_j - 2 f1_i.f2_j + f2_i.f2_j`` over sqrt(C), and window entry
    (i, j) samples ``(x + delta[i], y + delta[j])``.  fmap1/fmap2:
    [B, H, W, C]."""

    def __init__(self, fmap1: torch.Tensor, fmap2: torch.Tensor,
                 num_levels: int = 4, radius: int = 4):
        self.num_levels = num_levels
        self.radius = radius
        b, h, w, c = fmap1.shape
        self.shape = (b, h, w)
        f1 = fmap1.reshape(b, h * w, c)
        f2 = fmap2.reshape(b, h * w, c)
        x2 = torch.einsum("bic,bjc->bij", f1, f1)
        y2 = torch.einsum("bic,bjc->bij", f2, f2)
        xy = torch.einsum("bic,bjc->bij", f1, f2)
        corr = ((x2 - 2 * xy + y2) / math.sqrt(c)).reshape(b * h * w, h, w, 1)
        self.pyramid = [corr]
        for _ in range(num_levels - 1):
            # non-overlapping 2x2 mean, the remainder dropped (VALID)
            hh, ww = corr.shape[1] // 2 * 2, corr.shape[2] // 2 * 2
            corr = avg_pool2d(corr[:, :hh, :ww], (2, 2))
            self.pyramid.append(corr)

    def __call__(self, coords: torch.Tensor) -> torch.Tensor:
        """coords: [B, H, W, 2] (x, y) target positions -> [B, H, W,
        num_levels * (2r + 1)^2]."""
        b, h, w = self.shape
        r = self.radius
        flat = coords.reshape(b * h * w, 1, 1, 2)
        d = torch.arange(-r, r + 1, dtype=coords.dtype, device=coords.device)
        di, dj = torch.meshgrid(d, d, indexing="ij")
        delta = torch.stack([di, dj], dim=-1)[None]        # [1, P, P, 2]
        out = []
        for lvl, corr in enumerate(self.pyramid):
            sampled = grid_sample(corr, flat / 2 ** lvl + delta)
            out.append(sampled.reshape(b, h, w, -1))
        return torch.cat(out, dim=-1)
