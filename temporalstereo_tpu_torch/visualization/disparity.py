"""Disparity colour maps in numpy: copies of the JAX package's
``visualization/disparity.py`` ``disp_to_color`` (the KITTI devkit's
histogram-equalised map), ``disp_err_to_color`` (the devkit's binned
error colours) and ``disp_err_to_colorbar`` (the piecewise re-valued jet
error map with its optional legend bar)."""
from __future__ import annotations

import numpy as np

from .colormap import jet

# KITTI devkit colour histogram: (r, g, b, bin weight) segments
_KITTI_MAP = np.array([
    [0, 0, 0, 114], [0, 0, 1, 185], [1, 0, 0, 114], [1, 0, 1, 174],
    [0, 1, 0, 114], [0, 1, 1, 185], [1, 1, 0, 114], [1, 1, 1, 0],
], dtype=np.float64)


def disp_map(disp: np.ndarray) -> np.ndarray:
    """Normalised disparities [N, 1] in [0, 1] -> RGB [N, 3]."""
    disp = np.asarray(disp, np.float64).reshape(-1, 1)
    bins = _KITTI_MAP[:-1, 3].astype(float).reshape(-1, 1)
    cbins = np.cumsum(bins)
    bins = bins / cbins[-1]
    cbins6 = (cbins[:-1] / cbins[-1]).reshape(-1, 1)
    s = np.sum(disp.reshape(1, -1) > cbins6, axis=0)
    inv_bins = 1.0 / bins
    cbins_padded = np.zeros((cbins6.size + 1, 1))
    cbins_padded[1:] = cbins6
    frac = (disp - cbins_padded[s]) * inv_bins[s]
    return (_KITTI_MAP[s, 0:3] * np.tile(1 - frac, (1, 3))
            + _KITTI_MAP[s + 1, 0:3] * np.tile(frac, (1, 3)))


def disp_to_color(disp: np.ndarray, max_disp: float | None = None
                  ) -> np.ndarray:
    """[H, W] disparity -> [H, W, 3] f32 RGB in [0, 1]."""
    disp = np.asarray(disp, np.float64)
    h, w = disp.shape
    if max_disp is None:
        max_disp = np.max(disp)
    x = disp / max_disp
    return disp_map(x.reshape(h * w, 1)).reshape(h, w, 3).astype(np.float32)


# KITTI devkit error colours: (lower, upper bound of min(E / 3 px, rel / 5%),
# r, g, b)
_ERR_COLS = np.array([
    [0 / 3.0, 0.1875 / 3.0, 49, 54, 149],
    [0.1875 / 3.0, 0.375 / 3.0, 69, 117, 180],
    [0.375 / 3.0, 0.75 / 3.0, 116, 173, 209],
    [0.75 / 3.0, 1.5 / 3.0, 171, 217, 233],
    [1.5 / 3.0, 3 / 3.0, 224, 243, 248],
    [3 / 3.0, 6 / 3.0, 254, 224, 144],
    [6 / 3.0, 12 / 3.0, 253, 174, 97],
    [12 / 3.0, 24 / 3.0, 244, 109, 67],
    [24 / 3.0, 48 / 3.0, 215, 48, 39],
    [48 / 3.0, np.inf, 165, 0, 38],
], dtype=np.float64)


def disp_err_to_color(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """The KITTI devkit's error colours of [H, W] maps normalised to
    [0, 1] (scaled by 255 here): the error min(|E| / 3 px, |E| / gt / 5%)
    binned with inclusive bounds, later bins winning ties; pixels without
    ground truth stay black -> [H, W, 3] f64 in [0, 1]."""
    est = np.asarray(est, np.float64) * 255.0
    gt = np.asarray(gt, np.float64) * 255.0
    e = np.abs(est - gt)
    not_empty = gt > 0.0
    tmp = np.zeros_like(gt)
    tmp[not_empty] = e[not_empty] / gt[not_empty] / 0.05
    e = np.minimum(e / 3.0, tmp)

    h, w = gt.shape
    out = np.zeros((h, w, 3), np.uint8)
    for col in _ERR_COLS:
        m = not_empty & (e >= col[0]) & (e <= col[1])
        out[m] = col[2:]
    return out.astype(np.float64) / 255.0


def _revalue(m: np.ndarray, lower: float, upper: float, start: float,
             scale: float) -> np.ndarray:
    """Re-normalise the values in (lower, upper] to [start, start + scale]."""
    mask = (m > lower) & (m <= upper)
    if np.sum(mask) >= 1.0:
        mn, mx = m[mask].min(), m[mask].max()
        m[mask] = ((m[mask] - mn) / (mx - mn + 1e-7)) * scale + start
    return m


def disp_err_to_colorbar(est: np.ndarray, gt: np.ndarray,
                         with_bar: bool = False) -> np.ndarray:
    """|est - gt| over valid gt, re-valued piecewise at 0/1/2/4/12/16/192 px
    and coloured with jet -> [H, W, 3] f64 (with a 50-pixel legend bar
    below, [H + 50, W, 3], when ``with_bar``)."""
    est = np.asarray(est, np.float64)
    gt = np.asarray(gt, np.float64)
    error_bar_height = 50
    error_map = np.abs(est - gt) * (gt > 0)
    h, w = error_map.shape
    maxvalue = error_map.max()
    breakpoints = np.array([0, 1, 2, 4, 12, 16, max(192, maxvalue)])
    points = np.array([0, 0.25, 0.38, 0.66, 0.83, 0.95, 1])
    num_bins = np.array([0, w // 8, w // 8, w // 4, w // 4, w // 8,
                         w - (w // 4 + w // 4 + w // 8 + w // 8 + w // 8)])
    for i in range(1, len(breakpoints)):
        error_map = _revalue(error_map, breakpoints[i - 1], breakpoints[i],
                             points[i - 1], points[i] - points[i - 1])
    error_map = jet(error_map)
    if not with_bar:
        return error_map
    error_bar = np.concatenate(
        [np.linspace(points[i - 1], points[i], num_bins[i])
         for i in range(1, len(num_bins))])
    error_bar = np.repeat(error_bar, error_bar_height).reshape(
        w, error_bar_height).transpose(1, 0)
    return np.concatenate((error_map, jet(error_bar)), axis=0)
