"""Image transforms of the inference CLI: ImageNet normalisation and the
align-corners bilinear resize of images and disparities.

Copies of the JAX package's ``data/transforms.py`` functions.  The resize
is the align-corners bilinear resize of the JAX package's native
``ts_resize_bilinear`` (``native/tsnative.cpp``) in numpy, with the same
arithmetic: source coordinates in float64, weights and blends in f32.
(``F.interpolate`` computes the coordinates in f32, which moves a pixel by
up to a few 1e-6.)
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD
              ) -> np.ndarray:
    """(img - mean) / std in f32, subtraction then division."""
    out = np.subtract(img, np.asarray(mean, np.float32), dtype=np.float32)
    np.divide(out, np.asarray(std, np.float32), out=out)
    return out


def denormalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD
                ) -> np.ndarray:
    return (img * std + mean).astype(np.float32)


def _taps(n_in: int, n_out: int):
    """(lower index, upper index, f32 weight of the upper) per output
    position of an align-corners resize of n_in to n_out samples."""
    scale = (n_in - 1) / (n_out - 1) if n_out > 1 else 0.0
    src = np.arange(n_out) * scale
    lo = np.minimum(src.astype(np.int64), max(n_in - 2, 0))
    return lo, np.minimum(lo + 1, n_in - 1), (src - lo).astype(np.float32)


def resize_image(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Align-corners bilinear resize of [H, W, C] f32 to ``size`` (h, w)."""
    h, w = size
    if img.shape[:2] == (h, w):
        return img
    img = np.ascontiguousarray(img, np.float32)
    y0, y1, wy = _taps(img.shape[0], h)
    x0, x1, wx = _taps(img.shape[1], w)
    wx, wy = wx[None, :, None], wy[:, None, None]
    r0, r1 = img[y0], img[y1]
    top = r0[:, x0] * (1 - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (1 - wx) + r1[:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_disparity(disp: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize an [H, W] disparity and scale its values by the width ratio."""
    h, w = size
    if disp.shape[:2] == (h, w):
        return disp
    scale = w / disp.shape[1]
    return resize_image(disp[..., None], size)[..., 0] * scale
