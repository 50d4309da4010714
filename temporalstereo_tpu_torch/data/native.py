"""The host data path in C++ (``csrc/tsnative.cpp``), loaded with ctypes.

Counterpart of the JAX package's ``data/native.py``: PFM and PNG decoding,
the align-corners resize, the colour jitter, normalisation and cropping.
The library is compiled with g++ at first use into
``kernels/_build/libtsnative_<hash>.so`` (listed in ``.gitignore``); the
hash covers the source, the flags and the host, so an edited source or
another machine builds anew.  Concurrent first uses (test workers, loader
processes) build once: under a lock file, to a temporary name, then
``os.replace``.  A failed build raises with the compiler's message.
``build`` also compiles the port's other host library, the zstd decoder
of ``utils/zstd.py``.

``formats.py``, ``png.py`` and ``transforms.py`` call it by default, where
the JAX package's data path calls its library; their numpy paths run only
when the caller asks (``use_native=False``).  The PNG decoder inflates with Python's ``zlib`` and
hands the C++ only the row unfiltering, so the library needs no zlib.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "tsnative.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "kernels" / "_build"
# the JAX package's native/Makefile flags: the same code built the same way
# computes the same bits (-march=native contracts the resize's blends into
# FMAs; -fno-math-errno lets GCC vectorise the jitter's powf and fmodf)
CXXFLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
            "-fno-math-errno", "-shared", "-pthread"]

_LIB: Optional[ctypes.CDLL] = None
_BUILD: Dict[str, object] = {}
_f32p = ctypes.c_void_p
_int = ctypes.c_int


def resolve(use_native: Optional[bool]) -> bool:
    """``use_native=None`` means the library; only False means numpy."""
    return True if use_native is None else bool(use_native)


def library_path(source: Optional[Path] = None, stem: str = "tsnative"
                 ) -> Path:
    source = SOURCE if source is None else source
    digest = hashlib.sha256(source.read_bytes() + " ".join(
        CXXFLAGS + [platform.machine(), platform.node()]).encode())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build(source: Optional[Path] = None, stem: str = "tsnative"
          ) -> Dict[str, object]:
    """Compile the library of ``source`` (this module's by default) into
    ``lib<stem>_<hash>.so`` unless it exists -> {"path", "built",
    "seconds", "log"}.  Raises RuntimeError with the compiler's output if
    g++ fails."""
    source = SOURCE if source is None else source
    target = library_path(source, stem)
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    built, log = False, ""
    with open(BUILD_DIR / f"{stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not target.exists():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp),
                   str(source)]
            try:
                out = subprocess.run(cmd, capture_output=True, text=True,
                                     timeout=300)
            except OSError as exc:
                raise RuntimeError(f"{source.name} cannot be built: {exc}"
                                   ) from exc
            log = (out.stdout + out.stderr).strip()
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed to build {source.name}:\n"
                                   f"{log}")
            os.replace(tmp, target)
            built = True
    return {"path": str(target), "built": built,
            "seconds": time.perf_counter() - t0, "log": log}


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _LIB
    if _LIB is None:
        _BUILD.update(build())
        lib = ctypes.CDLL(_BUILD["path"])
        lib.ts_decode_pfm.restype = _int
        lib.ts_decode_pfm.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(_int),
            ctypes.POINTER(_int), ctypes.POINTER(_int),
            ctypes.POINTER(ctypes.c_double), _f32p]
        lib.ts_resize_bilinear.restype = None
        lib.ts_resize_bilinear.argtypes = [_f32p, _int, _int, _int, _f32p,
                                           _int, _int]
        lib.ts_normalize.restype = None
        lib.ts_normalize.argtypes = [_f32p, ctypes.c_int64, _int, _f32p,
                                     _f32p]
        lib.ts_crop.restype = None
        lib.ts_crop.argtypes = [_f32p] + [_int] * 7 + [_f32p]
        lib.ts_color_jitter.restype = None
        lib.ts_color_jitter.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_void_p, _int] + [
            ctypes.c_float] * 5
        lib.ts_png_unfilter.restype = _int
        lib.ts_png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                        ctypes.c_int64, _int, _int,
                                        ctypes.c_void_p]
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def decode_pfm(buf: bytes) -> Tuple[np.ndarray, float]:
    """PFM bytes -> (array [H, W] or [H, W, 3] f32, top row first, the
    header's |scale|).  Raises ValueError for a malformed file."""
    lib = library()
    arr = np.frombuffer(buf, dtype=np.uint8)
    h, w, c, scale = _int(), _int(), _int(), ctypes.c_double()
    dims = (ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
            ctypes.byref(scale))
    rc = lib.ts_decode_pfm(_ptr(arr), len(buf), *dims, None)
    if rc != 0:
        raise ValueError(f"malformed PFM header (ts_decode_pfm {rc})")
    out = np.empty((h.value, w.value, c.value), np.float32)
    rc = lib.ts_decode_pfm(_ptr(arr), len(buf), *dims, _ptr(out))
    if rc != 0:
        raise ValueError(f"truncated PFM data (ts_decode_pfm {rc})")
    return (out[..., 0] if c.value == 1 else out), abs(scale.value)


def png_unfilter(filtered: np.ndarray, bpp: int, depth: int) -> np.ndarray:
    """Inflated PNG image data [H, 1 + W * bpp] uint8 (a filter byte per
    row) -> samples [H, W * bpp] uint8, or [H, W * bpp / 2] uint16 in native
    order at 16 bits.  Raises ValueError for an unknown filter."""
    filtered = np.ascontiguousarray(filtered, np.uint8)
    h, stride = filtered.shape[0], filtered.shape[1] - 1
    out = np.empty((h, stride // 2) if depth == 16 else (h, stride),
                   np.uint16 if depth == 16 else np.uint8)
    rc = library().ts_png_unfilter(_ptr(filtered), h, stride, bpp, depth,
                                   _ptr(out))
    if rc != 0:
        raise ValueError("unknown PNG row filter")
    return out


def decode_png(buf: bytes) -> np.ndarray:
    """PNG bytes -> uint8 or uint16 [H, W] / [H, W, C]: the port's reader
    (``png.py``) with the native unfiltering."""
    from .png import decode_png as decode

    return decode(buf, use_native=True)


def resize_bilinear(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Align-corners bilinear resize of [H, W] or [H, W, C] f32 to
    ``size`` (h, w)."""
    oh, ow = size
    img = np.ascontiguousarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    h, w, c = img.shape
    out = np.empty((oh, ow, c), np.float32)
    library().ts_resize_bilinear(_ptr(img), h, w, c, _ptr(out), oh, ow)
    return out[..., 0] if squeeze else out


def color_jitter_inplace(img: np.ndarray, order: np.ndarray, fb: float,
                         fc: float, fs: float, fh: float, fgamma: float
                         ) -> np.ndarray:
    """torchvision's colour jitter on [H, W, 3] f32 in [0, 1], in place:
    the four adjustments (0 brightness, 1 contrast, 2 saturation, 3 hue) in
    ``order`` with their factors, then the gamma.  The caller draws the
    randomness."""
    if img.dtype != np.float32 or not img.flags.c_contiguous \
            or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("color_jitter_inplace takes a C-contiguous "
                         "[H, W, 3] float32 image")
    order = np.ascontiguousarray(order, np.int32)
    library().ts_color_jitter(_ptr(img), img.shape[0] * img.shape[1],
                              _ptr(order), len(order), fb, fc, fs, fh,
                              fgamma)
    return img


def normalize_inplace(img: np.ndarray, mean: np.ndarray,
                      std: np.ndarray) -> np.ndarray:
    """(img - mean) / std over the channels of [H, W, C] f32, in place when
    ``img`` is C-contiguous f32 (else on a copy, which is returned)."""
    img = np.ascontiguousarray(img, np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    h, w, c = img.shape
    library().ts_normalize(_ptr(img), h * w, c, _ptr(mean), _ptr(std))
    return img


def ts_crop(img: np.ndarray, y: int, x: int, h: int, w: int) -> np.ndarray:
    """A copy of the [h, w] window at (y, x) of [H, W, C] f32."""
    img = np.ascontiguousarray(img, np.float32)
    squeeze = img.ndim == 2
    if squeeze:
        img = img[..., None]
    ih, iw, c = img.shape
    if y < 0 or x < 0 or y + h > ih or x + w > iw:
        raise ValueError(f"crop {(y, x, h, w)} outside {(ih, iw)}")
    out = np.empty((h, w, c), np.float32)
    library().ts_crop(_ptr(img), ih, iw, c, y, x, h, w, _ptr(out))
    return out[..., 0] if squeeze else out
