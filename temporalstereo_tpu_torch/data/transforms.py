"""Host-side transforms (numpy): ImageNet normalisation, the resizes,
the training augmentation (colour jitter, random crop, right-view
occlusion) and the intrinsics that follow a crop or a resize.

Copies of the JAX package's ``data/transforms.py`` functions.  The resize
of images and disparities is the align-corners bilinear resize
``ts_resize_bilinear`` of the native library (``data/native.py``), as in
the JAX package; its numpy path (``use_native=False``) has the same
arithmetic, source coordinates in float64, weights and blends in f32, but
without the FMAs the compiler may contract the native blends into, so it
can differ in the last bit.  (``F.interpolate`` computes the coordinates in
f32, which moves a pixel by up to a few 1e-6.)  ``resize_pil_bilinear`` is
Pillow's bilinear resample of a float image, which the JAX package's video
CLI applies to its estimate before the ground-truth metrics.
``color_jitter`` runs natively by default, as the JAX package's does; its
numpy path agrees with the native kernel to 3e-5.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np

from . import native

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def normalize(img: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD,
              use_native: Optional[bool] = None) -> np.ndarray:
    """(img - mean) / std of [H, W, C] in f32, subtraction then division
    (the same IEEE operations natively and in numpy: the same bits)."""
    if native.resolve(use_native) and np.ndim(img) == 3:
        return native.normalize_inplace(np.array(img, np.float32), mean, std)
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


def resize_image(img: np.ndarray, size: Tuple[int, int],
                 use_native: Optional[bool] = None) -> np.ndarray:
    """Align-corners bilinear resize of [H, W, C] f32 to ``size`` (h, w),
    natively unless ``use_native`` is False."""
    h, w = size
    if img.shape[:2] == (h, w):
        return img
    if native.resolve(use_native):
        return native.resize_bilinear(img, size)
    img = np.ascontiguousarray(img, np.float32)
    y0, y1, wy = _taps(img.shape[0], h)
    x0, x1, wx = _taps(img.shape[1], w)
    wx, wy = wx[None, :, None], wy[:, None, None]
    r0, r1 = img[y0], img[y1]
    top = r0[:, x0] * (1 - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (1 - wx) + r1[:, x1] * wx
    return top * (1 - wy) + bot * wy


def resize_disparity(disp: np.ndarray, size: Tuple[int, int],
                     use_native: Optional[bool] = None) -> np.ndarray:
    """Resize an [H, W] disparity and scale its values by the width ratio."""
    h, w = size
    if disp.shape[:2] == (h, w):
        return disp
    scale = w / disp.shape[1]
    return resize_image(disp[..., None], size, use_native)[..., 0] * scale


def _pil_taps(n_in: int, n_out: int):
    """Pillow's bilinear resample of n_in samples to n_out
    (``Resample.c:precompute_coeffs``): the triangle filter's support
    widens with the scale when shrinking, centres at (i + 0.5) * scale,
    weights normalised in float64 -> (first source index [n_out], weights
    [n_out, taps])."""
    scale = n_in / n_out
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    taps = int(math.ceil(support)) * 2 + 1
    center = (np.arange(n_out) + 0.5) * scale
    ss = 1.0 / filterscale
    # C's (int) truncates toward zero, as astype does
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      n_in) - xmin
    x = np.arange(taps)[None, :]
    w = np.abs((x + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where((w < 1.0) & (x < xmax[:, None]), 1.0 - w, 0.0)
    total = np.zeros(n_out)
    for j in range(taps):                 # Pillow's order of additions
        total = total + w[:, j]
    return xmin, w / np.where(total == 0.0, 1.0, total)[:, None]


def _pil_pass(img: np.ndarray, n_out: int, axis: int) -> np.ndarray:
    n_in = img.shape[axis]
    xmin, w = _pil_taps(n_in, n_out)
    src = np.moveaxis(img, axis, 0)
    acc = np.zeros((n_out,) + src.shape[1:])
    expand = (slice(None),) + (None,) * (src.ndim - 1)
    for j in range(w.shape[1]):
        idx = np.minimum(xmin + j, n_in - 1)
        acc += src[idx].astype(np.float64) * w[:, j][expand]
    return np.moveaxis(acc.astype(np.float32), 0, axis)


def resize_pil_bilinear(img: np.ndarray, size: Tuple[int, int]
                        ) -> np.ndarray:
    """Pillow's ``Image.resize(size, BILINEAR)`` of a float image [H, W] or
    [H, W, C] (each channel alone) to ``size`` (h, w), in numpy: a width
    pass, then a height pass, each summing in float64 and rounding to f32,
    as Pillow's ``F`` mode does; a pass whose size does not change is
    skipped."""
    h, w = size
    out = np.asarray(img, np.float32)
    if out.shape[1] != w:
        out = _pil_pass(out, w, 1)
    if out.shape[0] != h:
        out = _pil_pass(out, h, 0)
    return out.copy() if out is img else out


def _rgb_to_hsv(rgb: np.ndarray):
    """RGB -> HSV of [H, W, 3] floats in [0, 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(axis=-1)
    minc = rgb.min(axis=-1)
    v = maxc
    delta = maxc - minc
    s = np.where(maxc > 0, delta / np.maximum(maxc, 1e-12), 0.0)
    safe = np.maximum(delta, 1e-12)
    h = np.where(maxc == r, (g - b) / safe,
                 np.where(maxc == g, 2.0 + (b - r) / safe,
                          4.0 + (r - g) / safe))
    h = np.where(delta > 0, (h / 6.0) % 1.0, 0.0)
    return h, s, v


def _hsv_to_rgb(h: np.ndarray, s: np.ndarray, v: np.ndarray) -> np.ndarray:
    """HSV -> RGB per channel c with offset n in (5, 3, 1):
    v * (1 - s * clip(min(k, 4 - k), 0, 1)), k = (n + 6h) mod 6."""
    h6 = (h % 1.0) * 6.0
    out = np.empty(h.shape + (3,), np.float32)
    for c, n in enumerate((5.0, 3.0, 1.0)):
        k = (n + h6) % 6.0
        t = np.minimum(k, 4.0 - k, out=k)
        np.clip(t, 0.0, 1.0, out=t)
        out[..., c] = v * (1.0 - s * t)
    return out


def _blend(img1: np.ndarray, img2: np.ndarray, ratio: float) -> np.ndarray:
    """torchvision's _blend: ratio * img1 + (1 - ratio) * img2 in [0, 1]."""
    return np.clip(ratio * img1 + (1.0 - ratio) * img2, 0.0, 1.0)


def _grayscale(img: np.ndarray) -> np.ndarray:
    """ITU-R 601-2 luma (torchvision's rgb_to_grayscale)."""
    return (0.2989 * img[..., 0] + 0.587 * img[..., 1]
            + 0.114 * img[..., 2])[..., None]


def color_jitter(img: np.ndarray, rng: np.random.RandomState,
                 brightness: Tuple[float, float] = (0.4, 2.0),
                 contrast: Tuple[float, float] = (0.5, 1.5),
                 saturation: Tuple[float, float] = (0.5, 1.5),
                 hue: Tuple[float, float] = (-0.1, 0.1),
                 gamma: Tuple[float, float] = (0.8, 1.2),
                 use_native: Optional[bool] = None) -> np.ndarray:
    """torchvision's ColorJitter (brightness, contrast, saturation, hue in a
    random order) then a gamma, on [H, W, 3] floats in [0, 1], with the
    reference's factor ranges.  Draws from ``rng`` in a fixed sequence: the
    four factors, the order, the gamma.  The pixel work runs in the native
    kernel for an RGB image unless ``use_native`` is False, as the JAX
    package's ``use_native=None`` does."""
    fb = rng.uniform(*brightness)
    fc = rng.uniform(*contrast)
    fs = rng.uniform(*saturation)
    fh = rng.uniform(*hue)
    order = rng.permutation(4)
    g = rng.uniform(*gamma)

    if native.resolve(use_native) and img.ndim == 3 and img.shape[-1] == 3:
        out = np.ascontiguousarray(img, np.float32)
        out = out.copy() if out is img else out
        return native.color_jitter_inplace(out, order, fb, fc, fs, fh, g)

    out = img.astype(np.float32)
    for op in order:
        if op == 0:    # brightness: a blend with black
            out = np.clip(out * fb, 0.0, 1.0)
        elif op == 1:  # contrast: a blend with the mean gray
            out = _blend(out, _grayscale(out).mean(), fc)
        elif op == 2:  # saturation: a blend with the gray image
            out = _blend(out, _grayscale(out), fs)
        else:          # hue: a rotation in HSV
            h, s_, v = _rgb_to_hsv(out)
            out = _hsv_to_rgb((h + fh) % 1.0, s_, v)
    out = np.clip(out, 0.0, 1.0) ** g
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def random_crop_params(rng: np.random.RandomState, h: int, w: int,
                       crop_h: int, crop_w: int) -> Tuple[int, int]:
    y = rng.randint(0, max(h - crop_h, 0) + 1)
    x = rng.randint(0, max(w - crop_w, 0) + 1)
    return y, x


def crop(arr: np.ndarray, y: int, x: int, h: int, w: int) -> np.ndarray:
    return arr[y:y + h, x:x + w]


def right_occlusion_aug(right: np.ndarray, rng: np.random.RandomState,
                        prob: float = 0.5,
                        patch_h: Sequence[int] = (50, 125),
                        patch_w: Sequence[int] = (50, 250)) -> np.ndarray:
    """With probability ``prob``, a rectangle of the right view's mean
    colour pasted at a random place."""
    if rng.rand() >= prob:
        return right
    h, w = right.shape[:2]
    ph = rng.randint(patch_h[0], patch_h[1])
    pw = rng.randint(patch_w[0], patch_w[1])
    ph, pw = min(ph, h), min(pw, w)
    y = rng.randint(0, h - ph + 1)
    x = rng.randint(0, w - pw + 1)
    out = right.copy()
    out[y:y + ph, x:x + pw] = right.mean(axis=(0, 1))
    return out


def scale_intrinsics(K: np.ndarray, scale_x: float, scale_y: float
                     ) -> np.ndarray:
    out = K.copy()
    out[0, :] *= scale_x
    out[1, :] *= scale_y
    return out


def crop_intrinsics(K: np.ndarray, y: int, x: int) -> np.ndarray:
    out = K.copy()
    out[0, 2] -= x
    out[1, 2] -= y
    return out
