"""Align-corners resizes and pooling.

Counterpart of the JAX package's ``ops/interpolate.py``.  The JAX package
builds interpolation matrices because gathers are slow on a TPU; here
``F.interpolate(..., align_corners=True)`` computes the same resize.
Functions take the JAX layouts (NHWC images, NDHWC volumes) by default; the
``*_axis`` / ``axes`` arguments name other layouts, such as the model's
channels-first tensors.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def _resize(x: torch.Tensor, size: Sequence[int], axes: Sequence[int],
            mode: str) -> torch.Tensor:
    axes = [a % x.ndim for a in axes]
    if tuple(x.shape[a] for a in axes) == tuple(size):
        return x          # identity short-cut (JAX _apply_axis)
    rest = [i for i in range(x.ndim) if i not in axes]
    perm = rest + axes
    y = x.permute(perm)
    lead = y.shape[:len(rest)]
    y = y.reshape(1, -1, *y.shape[len(rest):])
    y = F.interpolate(y, size=tuple(size), mode=mode, align_corners=True)
    y = y.reshape(*lead, *size)
    inv = [0] * x.ndim
    for i, p in enumerate(perm):
        inv[p] = i
    return y.permute(inv)


def resize_bilinear(x: torch.Tensor, size: Tuple[int, int],
                    h_axis: int = -3, w_axis: int = -2) -> torch.Tensor:
    """Bilinear align-corners resize, default layout [..., H, W, C]."""
    return _resize(x, size, (h_axis, w_axis), "bilinear")


def resize_trilinear(x: torch.Tensor, size: Tuple[int, int, int],
                     axes: Tuple[int, int, int] = (1, 2, 3)) -> torch.Tensor:
    """Trilinear align-corners resize, default layout NDHWC."""
    return _resize(x, size, axes, "trilinear")


def avg_pool3d(x: torch.Tensor, window: Tuple[int, int, int]) -> torch.Tensor:
    """Non-overlapping average pool over NDHWC (stride = window, no padding,
    floor semantics: the remainder is dropped): a reshape-mean over views
    of ``x``, with no copy of the input.  (The model's overlapping 5x5x5
    pools run channels-first in ``nn/blocks.py:PyramidFusion``.)"""
    b, d, h, w, c = x.shape
    kd, kh, kw = window
    dt, ht, wt = d // kd, h // kh, w // kw
    y = x[:, :dt * kd, :ht * kh, :wt * kw]
    return y.reshape(b, dt, kd, ht, kh, wt, kw, c).mean(dim=(2, 4, 6))


def _window_view(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """[..., H, W, C] -> [..., H/kh, kh, W/kw, kw, C] for a window that
    divides H and W."""
    h, w, c = x.shape[-3:]
    kh, kw = window
    if h % kh or w % kw:
        raise ValueError(f"pool window {window} does not divide {(h, w)}")
    return x.reshape(*x.shape[:-3], h // kh, kh, w // kw, kw, c)


def avg_pool2d(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Non-overlapping average pool over [..., H, W, C] (stride = window, no
    padding), for a window that divides H and W."""
    return _window_view(x, window).mean(dim=(-4, -2))


def max_pool2d(x: torch.Tensor, window: Tuple[int, int]) -> torch.Tensor:
    """Non-overlapping max pool over [..., H, W, C], as ``avg_pool2d``."""
    return _window_view(x, window).amax(dim=(-4, -2))


def _adaptive_window(x: torch.Tensor, size: Tuple[int, int]
                     ) -> Tuple[int, int]:
    h, w = x.shape[-3:-1]
    oh, ow = size
    if h % oh or w % ow:
        raise ValueError(f"adaptive pools take divisible sizes only: "
                         f"{(h, w)} -> {tuple(size)}")
    return h // oh, w // ow


def adaptive_avg_pool2d(x: torch.Tensor, size: Tuple[int, int]
                        ) -> torch.Tensor:
    """[..., H, W, C] -> [..., oh, ow, C] for sizes that divide H and W (the
    losses' ground-truth rescale)."""
    window = _adaptive_window(x, size)
    return x if window == (1, 1) else avg_pool2d(x, window)


def adaptive_max_pool2d(x: torch.Tensor, size: Tuple[int, int]
                        ) -> torch.Tensor:
    """Max-pool counterpart of ``adaptive_avg_pool2d``."""
    window = _adaptive_window(x, size)
    return x if window == (1, 1) else max_pool2d(x, window)
