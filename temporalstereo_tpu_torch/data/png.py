"""PNG read and write with the standard library's ``zlib`` and numpy.

The port's image codec, so that it needs no imaging package: non-interlaced
gray, gray + alpha, RGB and RGBA at 8 or 16 bits a sample (KITTI's flow
files are 16-bit RGB), all five row filters (PNG specification, section
9).  Anything else (palette, other bit depths, interlaced) raises
ValueError.

Reading undoes each row's filter.  The Sub, Average and Paeth filters make
a byte depend on the reconstructed byte to its left, so where a row has
the Average or Paeth filter the decoder walks the image one anti-diagonal
of pixels at a time: a pixel depends only on
its left, upper and upper-left neighbours, which all lie on earlier
diagonals, so every row advances in one vectorised step per diagonal.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 gray, 2 RGB, 4 gray + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {v: k for k, v in _CHANNELS.items()}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc, = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG")


def _unfilter(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """filtered [H, 1 + W * bpp] uint8 (filter byte first) -> raw bytes
    [H, W, bpp]."""
    h = filtered.shape[0]
    kinds = filtered[:, 0].astype(np.int32)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG row filter {int(kinds.max())}")
    data = filtered[:, 1:].reshape(h, -1, bpp).astype(np.int32)
    w = data.shape[1]
    if kinds.max(initial=0) <= 2:
        # None, Sub and Up only: a row at a time (Sub is a running sum)
        out = np.zeros((h + 1, w, bpp), np.int32)
        for y in range(h):
            row = data[y]
            if kinds[y] == 1:
                row = np.cumsum(row, axis=0)
            elif kinds[y] == 2:
                row = row + out[y]
            out[y + 1] = row & 0xFF
        return out[1:].astype(np.uint8)
    # skewed layout: row y's pixel x sits at column x + y, and a zero row
    # above the image gives the first row its "up" neighbours
    skew = np.zeros((h + 1, w + h + 1, bpp), np.int32)
    rows = np.arange(h)
    for y in range(h):
        skew[y + 1, y + 1:y + 1 + w] = data[y]
    out = np.zeros_like(skew)
    masks = [(kinds == k)[:, None] for k in (1, 2, 3, 4)]
    for d in range(1, w + h):
        # pixel (y, x = d - y) of each row; a = left, b = up, c = up-left
        x = d - 1 - rows
        valid = ((x >= 0) & (x < w))[:, None]
        f = skew[1:, d]
        a = out[1:, d - 1]
        b = out[:-1, d - 1]
        c = out[:-1, d - 2] if d >= 2 else np.zeros_like(a)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select(masks, [a, b, (a + b) >> 1, paeth], 0)
        out[1:, d] = np.where(valid, (f + pred) & 0xFF, 0)
    return np.stack([out[y + 1, y + 1:y + 1 + w] for y in range(h)]
                    ).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """A PNG file -> uint8 or uint16 [H, W] (gray) / [H, W, C]."""
    with open(path, "rb") as fp:
        data = fp.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if color not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG of colour type {color} and bit depth "
                         f"{depth} is not supported (gray, gray + alpha, "
                         "RGB and RGBA at 8 or 16 bits are)")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: image data of {raw.size} bytes for "
                         f"{w}x{h}")
    pixels = _unfilter(raw.reshape(h, 1 + w * bpp), bpp)
    if depth == 16:
        pixels = pixels.reshape(h, w, bpp).view(">u2").astype(np.uint16)
    return pixels[..., 0] if channels == 1 else pixels


def _filter(raw: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """Raw bytes [H, W * bpp] -> filtered rows [H, 1 + W * bpp]."""
    r = raw.astype(np.int32)
    a = np.zeros_like(r)
    a[:, bpp:] = r[:, :-bpp]
    b = np.zeros_like(r)
    b[1:] = r[:-1]
    c = np.zeros_like(r)
    c[1:, bpp:] = r[:-1, :-bpp]
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    elif kind == 4:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    else:
        raise ValueError(f"unknown PNG row filter {kind}")
    out = np.empty((r.shape[0], r.shape[1] + 1), np.uint8)
    out[:, 0] = kind
    out[:, 1:] = (r - pred) & 0xFF
    return out


def write_png(path: str, image: np.ndarray, filter_type: int = 2) -> None:
    """uint8 or uint16 [H, W] / [H, W, 1|2|3|4] -> a PNG file, every row
    with ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    image = np.asarray(image)
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG takes uint8 or uint16, not {image.dtype}")
    if image.ndim == 2:
        image = image[..., None]
    channels = image.shape[-1]
    if image.ndim != 3 or channels not in _COLOR_TYPE:
        raise ValueError(f"cannot write a PNG of shape {image.shape}")
    depth = 8 * image.dtype.itemsize
    raw = image.astype(image.dtype.newbyteorder(">")).view(np.uint8).reshape(
        image.shape[0], -1)
    h, w = image.shape[:2]
    bpp = channels * depth // 8
    body = zlib.compress(_filter(raw, filter_type, bpp).tobytes())

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    header = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[channels], 0,
                         0, 0)
    with open(path, "wb") as fp:
        fp.write(SIGNATURE + chunk(b"IHDR", header) + chunk(b"IDAT", body)
                 + chunk(b"IEND", b""))
