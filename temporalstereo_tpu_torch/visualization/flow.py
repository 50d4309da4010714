"""Optical-flow colour maps in numpy: copies of the JAX package's
``visualization/flow.py`` ``flow_to_color`` (the Middlebury 55-segment
colour wheel) and ``flow_err_to_color`` (the KITTI end-point-error bins)."""
from __future__ import annotations

import numpy as np


def _make_color_wheel() -> np.ndarray:
    """The Middlebury wheel: segments RY 15, YG 6, GC 4, CB 11, BM 13,
    MR 6 -> [55, 3] in [0, 1]."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    wheel[:RY, 0] = 255
    wheel[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    wheel[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[col:col + YG, 1] = 255
    col += YG
    wheel[col:col + GC, 1] = 255
    wheel[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    wheel[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[col:col + CB, 2] = 255
    col += CB
    wheel[col:col + BM, 2] = 255
    wheel[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    wheel[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[col:col + MR, 0] = 255
    return wheel / 255.0


_WHEEL = _make_color_wheel()


def flow_to_color(flow: np.ndarray, max_flow: float | None = None
                  ) -> np.ndarray:
    """[H, W, 2] flow -> [H, W, 3] f32 RGB in [0, 1]: the hue from the
    direction, the saturation from the magnitude over ``max_flow`` (the
    largest magnitude by default); beyond it, colours darken to 75%."""
    u, v = flow[..., 0].astype(np.float64), flow[..., 1].astype(np.float64)
    rad = np.sqrt(u ** 2 + v ** 2)
    if max_flow is None:
        max_flow = max(rad.max(), 1e-9)
    u, v = u / max_flow, v / max_flow
    rad = np.sqrt(u ** 2 + v ** 2)
    angle = np.arctan2(-v, -u) / np.pi

    ncols = _WHEEL.shape[0]
    fk = (angle + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)

    out = np.zeros((*u.shape, 3))
    for c in range(3):
        col = (1 - f) * _WHEEL[k0, c] + f * _WHEEL[k1, c]
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] = col[~idx] * 0.75
        out[..., c] = col
    return out.astype(np.float32)


# KITTI error colours: end-point-error bin upper bounds (px) and RGB
_ERR_BINS = np.array(
    [0.1875, 0.375, 0.75, 1.5, 3.0, 6.0, 12.0, 24.0, 48.0, np.inf])
_ERR_RGB = np.array([
    [49, 54, 149], [69, 117, 180], [116, 173, 209], [171, 217, 233],
    [224, 243, 248], [254, 224, 144], [253, 174, 97], [244, 109, 67],
    [215, 48, 39], [165, 0, 38]], dtype=np.float32) / 255.0


def flow_err_to_color(est_flow: np.ndarray, gt_flow: np.ndarray,
                      gt_valid: np.ndarray | None = None) -> np.ndarray:
    """The end-point error of [H, W, 2] est against gt, binned into the
    KITTI colours (blue small, red large) -> [H, W, 3] f32 in [0, 1];
    pixels without valid ground truth are black."""
    epe = np.linalg.norm(
        np.asarray(gt_flow, np.float64) - np.asarray(est_flow, np.float64),
        axis=-1)
    valid = np.ones(epe.shape, bool) if gt_valid is None \
        else np.asarray(gt_valid) != 0
    epe = np.where(valid, epe, 0.0)
    idx = np.searchsorted(_ERR_BINS, epe, side="left")
    out = _ERR_RGB[np.minimum(idx, len(_ERR_RGB) - 1)]
    out[~valid] = 0.0
    return out.astype(np.float32)
