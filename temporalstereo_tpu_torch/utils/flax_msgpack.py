"""The JAX package's ``.msgpack`` weights, read without JAX, flax or msgpack.

The JAX package's ``training/checkpoint.py:save_weights`` writes
``flax.serialization.to_bytes({"params": ..., "batch_stats": ...})``: a
MessagePack map of nested maps whose leaves are flax's extension types
(``flax/serialization.py``):

  * code 1, ndarray: the MessagePack array ``[shape, dtype name, raw C-order
    bytes]``;
  * code 2, a native complex: ``[real, imag]``;
  * code 3, a numpy scalar: an ndarray of shape ``[]``;

and an array above flax's chunk limit (2**30 bytes) is a map
``{"__msgpack_chunked_array__": True, "shape": {"0": ..}, "chunks": {"0":
flat ndarray, ..}}``.  ``unpackb`` below is a MessagePack reader in pure
Python (nil, bool, ints, floats, str, bin, arrays, maps, ext) and
``restore`` rebuilds flax's tree with numpy arrays.  A ``bfloat16`` leaf
(numpy has no such type, and neither ``ml_dtypes`` nor ``jax`` is needed)
is widened by its bits to the float32 of the same value: bf16 is the upper
half of an IEEE float32.

``read_state_dict`` maps the tree through ``utils/convert.py:
state_dict_from_jax`` to the port's names.  The backbone's block structure
is read from the tree itself, and a tree that lacks some subtrees converts
what it holds; the caller merges the result by name and shape, as the JAX
package's ``warm_start(strict=False)`` merges.
"""
from __future__ import annotations

import re
import struct
from collections import namedtuple
from typing import Any, Dict, Tuple

import numpy as np
import torch

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """MessagePack's format (msgpack spec, 2017) over a byte string."""

    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        simple = {0xc0: None, 0xc2: False, 0xc3: True}
        if b in simple:
            return simple[b]
        sized = {0xc4: (">B", self.bin), 0xc5: (">H", self.bin),
                 0xc6: (">I", self.bin), 0xd9: (">B", self.str),
                 0xda: (">H", self.str), 0xdb: (">I", self.str),
                 0xdc: (">H", self.array), 0xdd: (">I", self.array),
                 0xde: (">H", self.map), 0xdf: (">I", self.map)}
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        numbers = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H",
                   0xce: ">I", 0xcf: ">Q", 0xd0: ">b", 0xd1: ">h",
                   0xd2: ">i", 0xd3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if 0xd4 <= b <= 0xd8:                       # fixext 1..16
            return self.ext(1 << (b - 0xd4))
        if 0xc7 <= b <= 0xc9:                       # ext 8/16/32
            return self.ext(self.unpack((">B", ">H", ">I")[b - 0xc7]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, n: int) -> Any:
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))


def unpackb(data: bytes) -> Any:
    """One MessagePack value from ``data`` (flax's extension types decoded);
    raises ValueError on anything else after it."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("msgpack: trailing data")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, name, buffer = unpackb(data)
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = unpackb(data)
        return complex(real, imag)
    raise ValueError(f"msgpack: unknown extension type {code}")


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays back into arrays, everywhere in ``tree``."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes) -> Any:
    """flax's ``msgpack_restore``: the tree of ``to_bytes``, numpy leaves
    (bf16 widened to f32)."""
    return _unchunk(unpackb(data))


_BlockSpec = namedtuple("_BlockSpec", "block_type repeats")
_BLOCK = re.compile(r"g(\d+)_s(\d+)_b(\d+)$")


def backbone_groups(backbone: Dict[str, Any]):
    """The trunk's groups of blocks as the tree holds them (``g{i}_s{j}_
    b{k}`` subtrees; an ``er`` block has ``conv_exp``): what
    ``state_dict_from_jax`` reads of a backbone spec."""
    blocks: Dict[Tuple[int, int], list] = {}
    for name, sub in backbone.items():
        m = _BLOCK.match(name)
        if m:
            gi, si, b = map(int, m.groups())
            kind = "er" if "conv_exp" in sub else "ir"
            blocks.setdefault((gi, si), []).append((b, kind))
    groups = []
    for gi, si in sorted(blocks):
        while len(groups) <= gi:
            groups.append([])
        found = blocks[(gi, si)]
        groups[gi].append(_BlockSpec(found[0][1], max(b for b, _ in found)
                                     + 1))
    return groups


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A JAX ``save_weights`` file -> the port's state_dict of the tensors
    it holds (CPU, f32; BatchNorm counters 0)."""
    with open(path, "rb") as fp:
        return tree_state_dict(restore(fp.read()))


def tree_state_dict(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX variables {"params", "batch_stats"} of a weights file or a
    checkpoint (numpy leaves) -> the port's state_dict of the tensors they
    hold (CPU, f32; BatchNorm counters 0)."""
    from .convert import state_dict_from_jax

    params = tree.get("params", {})
    stats = tree.get("batch_stats", {})
    return state_dict_from_jax(
        params, stats, backbone_groups(params.get("backbone", {})),
        partial=True)
