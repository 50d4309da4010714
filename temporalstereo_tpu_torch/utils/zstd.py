"""zstd decompression and the CRC-32C for the orbax reader, in C++.

``utils/orbax.py`` reads the JAX package's orbax checkpoints on a machine
that has neither orbax, tensorstore nor a zstd module: their OCDBT files
and zarr chunks are zstd frames.  The decoder (``csrc/zstd_decode.cpp``,
RFC 8878 without dictionaries) is compiled with g++ at first use into
``kernels/_build/libtszstd_<hash>.so`` by ``data/native.py:build`` (a
failed build raises with the compiler's message; there is no Python
fallback) and loaded with ctypes.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "zstd_decode.cpp"
_LIB: Optional[ctypes.CDLL] = None
BUILD: Dict[str, object] = {}
_ERR_CAP = 512


def library() -> ctypes.CDLL:
    """The loaded decoder, built first if needed (``BUILD`` then holds the
    build's path, whether it compiled and its seconds)."""
    global _LIB
    if _LIB is None:
        from ..data.native import build

        BUILD.update(build(SOURCE, "tszstd"))
        lib = ctypes.CDLL(BUILD["path"])
        ll = ctypes.c_longlong
        lib.tszstd_decompress.restype = ctypes.c_void_p
        lib.tszstd_decompress.argtypes = [
            ctypes.c_char_p, ll, ctypes.POINTER(ll), ctypes.POINTER(ll),
            ctypes.c_char_p, ll]
        lib.tszstd_free.restype = None
        lib.tszstd_free.argtypes = [ctypes.c_void_p]
        lib.tszstd_crc32c.restype = ctypes.c_uint32
        lib.tszstd_crc32c.argtypes = [ctypes.c_char_p, ll]
        _LIB = lib
    return _LIB


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data``, concatenated (skippable
    frames skipped).  Raises ValueError, with the offset into ``data``, for
    input that is not whole, well-formed zstd without a dictionary."""
    lib = library()
    data = bytes(data)
    size, offset = ctypes.c_longlong(), ctypes.c_longlong()
    err = ctypes.create_string_buffer(_ERR_CAP)
    ptr = lib.tszstd_decompress(data, len(data), ctypes.byref(size),
                                ctypes.byref(offset), err, _ERR_CAP)
    if offset.value >= 0:
        raise ValueError(f"zstd: {err.value.decode()} at byte "
                         f"{offset.value} of {len(data)}")
    if not ptr:
        return b""
    try:
        return ctypes.string_at(ptr, size.value)
    finally:
        lib.tszstd_free(ptr)


def crc32c(data: bytes) -> int:
    """The CRC-32C (Castagnoli) of ``data``."""
    data = bytes(data)
    return int(library().tszstd_crc32c(data, len(data)))

