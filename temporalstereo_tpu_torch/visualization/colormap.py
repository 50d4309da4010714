"""Colormaps in numpy: a copy of the JAX package's ``visualization/
colormap.py`` dispatcher, with matplotlib's ``jet`` built in so that the
port's CLI and error maps need no plotting package."""
from __future__ import annotations

from typing import Callable, Union

import numpy as np

N_COLORS = 256
# matplotlib's jet: per channel (x, y) knots of a piecewise-linear ramp
_JET = {"red": ((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0),
                (1.0, 0.5)),
        "green": ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0),
                  (0.91, 0.0), (1.0, 0.0)),
        "blue": ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0),
                 (1.0, 0.0))}


def _lookup_table(knots) -> np.ndarray:
    """N_COLORS samples of a ramp, as matplotlib's _create_lookup_table."""
    x, y = np.array(knots, np.float64).T
    xind = np.linspace(0, 1, N_COLORS)
    ind = np.searchsorted(x, xind)[1:-1]
    dist = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y[0]], dist * (y[ind] - y[ind - 1]) + y[ind - 1],
                          [y[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_lookup_table(_JET[c]) for c in ("red", "green", "blue")],
                   axis=-1)


def jet(data: np.ndarray) -> np.ndarray:
    """Values in [0, 1] -> RGB [..., 3] f64, as matplotlib's ``jet`` (256
    colours; below 0 the first, from 1 the last, NaN black)."""
    x = np.asarray(data, np.float64) * N_COLORS
    bad = np.isnan(x)
    x[x == N_COLORS] = N_COLORS - 1
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, x), -1, N_COLORS).astype(int)
    idx = np.clip(idx, 0, N_COLORS - 1)
    rgb = JET_LUT[idx]
    rgb[bad] = 0.0
    return rgb


def colormap(cmap: Union[str, Callable], data: np.ndarray, *args,
             normalize: bool = True, output_format: str = "HWC",
             **kwargs) -> np.ndarray:
    """Normalise ``data`` to [0, 1] (optionally) and colour it with ``cmap``,
    a callable or ``"jet"`` -> f32 HWC (or CHW)."""
    data = np.asarray(data)
    if data.ndim == 3 and data.shape[0] == 1:
        data = data[0]
    if normalize:
        lo, hi = float(data.min()), float(data.max())
        data = (data - lo) / max(hi - lo, 1e-9)
    if callable(cmap):
        img = cmap(data, *args, **kwargs)
    elif cmap == "jet":
        img = jet(np.clip(data, 0, 1))
    else:
        raise ValueError(f"unknown colormap {cmap!r}: pass a callable or "
                         "'jet'")
    img = np.asarray(img, np.float32)
    if output_format == "CHW":
        img = np.transpose(img, (2, 0, 1))
    return img
