"""Read the JAX package's orbax checkpoints with numpy alone.

The JAX package's ``training/checkpoint.py:CheckpointManager`` saves a
train state every N steps with orbax's ``CheckpointManager``: a directory
of integer step directories, each with ``default/`` holding an OCDBT
key-value store of zarr (v2) arrays, and ``hparams-<step>.json`` beside
them.  The machine with the card has neither orbax, tensorstore, JAX nor a
zstd module, so this module reads that layout itself, with numpy and the
C++ zstd decoder of ``utils/zstd.py``:

* **Steps** (``all_steps``, ``latest_step``): orbax's names, integer
  directories, temporary ``*.orbax-checkpoint-tmp-*`` ones skipped.
* **OCDBT** (``OcdbtReader``): ``manifest.ocdbt`` and B+tree nodes are an
  envelope of a big-endian magic (0x0cdb3a2a, 0x0cdb20de), the file's
  length (u64 LE), a varint version and a varint compression (0 none,
  1 zstd), the body and a CRC-32C of all before it (u32 LE), checked.  The
  manifest holds the config, a table of data files and the newest versions
  of the tree; a node holds its height, its data files, its entries' keys
  (each sharing a prefix with the one before), and either the children
  (interior: each with the prefix its subtree's keys share) or the values
  (leaf: inline, or a (file, offset, length) reference into a ``d/`` file;
  a data file's path may start with ``ocdbt.process_<i>/``, which is how
  orbax's top-level tree points into each process's).  Numbered manifests
  (not written by orbax) are refused.
* **zarr v2 arrays**: ``<name>/.zarray`` (dtype, ``bfloat16`` included,
  order, chunks, fill value, compressor ``zstd`` or none) and one key per
  chunk of the grid (``i.j``); an absent chunk is the fill value.
* **The tree**: ``default/_METADATA``'s ``tree_metadata`` names each leaf
  by its path of keys, ``key_type`` 2 a dict key and 1 a sequence index
  (a sequence comes back as a tuple); ``value_type`` ``scalar`` is a
  Python number, and the empty containers orbax does not store come back
  empty.

Leaves are numpy arrays; bf16 arrays are widened to f32 (exactly), as
``utils/flax_msgpack.py`` widens the JAX package's msgpack weights.
Malformed files raise ValueError with the file and the offset.
"""
from __future__ import annotations

import json
import os
import re
import struct
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .zstd import crc32c, decompress

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_STEP = re.compile(r"\d+$")
_KEY_DICT, _KEY_SEQUENCE = 2, 1
_EMPTY = {"Tuple": (), "Dict": {}, "None": None}


class _Cursor:
    """Reads the fields of one decoded OCDBT body; errors name the file and
    the offset in the body."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what} at byte {self.pos} of "
                         f"{len(self.data)}")

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            self.fail(f"truncated (want {n} bytes)")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            if shift > 63:
                self.fail("varint longer than 64 bits")
            byte = self.u8()
            value |= (byte & 0x7F) << shift
            shift += 7
            if byte < 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes left over")


def _envelope(data: bytes, magic: int, where: str) -> bytes:
    """The checked, decoded body of a manifest or node file."""
    if len(data) < 18:
        raise ValueError(f"{where}: {len(data)} bytes, too short")
    if struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"{where}: magic {data[:4].hex()}, want "
                         f"{magic:08x}")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise ValueError(f"{where}: its header says "
                         f"{struct.unpack('<Q', data[4:12])[0]} bytes, it "
                         f"has {len(data)}")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"{where}: CRC-32C mismatch")
    head = _Cursor(data[12:-4], where)
    if head.varint() != 0:
        head.fail("unknown format version")
    compression = head.varint()
    body = data[12 + head.pos:-4]
    if compression == 1:
        return decompress(body)
    if compression != 0:
        head.fail(f"unknown compression {compression}")
    return body


def _file_table(cur: _Cursor) -> List[str]:
    """A data-file table: paths (base path + relative path), each sharing a
    prefix with the one before."""
    n = cur.varint()
    shared = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    base = cur.varints(n)
    paths, prev = [], ""
    for i in range(n):
        if shared[i] > len(prev):
            cur.fail("file path prefix longer than the path before")
        prev = prev[:shared[i]] + cur.take(suffix[i]).decode()
        if base[i] > len(prev):
            cur.fail("base path longer than its path")
        paths.append(prev)
    return paths


def _keys(cur: _Cursor, n: int, interior: bool):
    """The n keys of a node (and, interior, each child's common prefix
    length)."""
    shared = [0] + cur.varints(n - 1) if n else []
    suffix = cur.varints(n)
    common = cur.varints(n) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            cur.fail("key prefix longer than the key before")
        prev = prev[:shared[i]] + cur.take(suffix[i])
        keys.append(prev)
    return keys, common


class OcdbtReader:
    """The key-value pairs of an OCDBT store (its newest version), read from
    the directory ``root`` (the one holding ``manifest.ocdbt``)."""

    def __init__(self, root):
        self.root = Path(root)
        where = str(self.root / "manifest.ocdbt")
        cur = _Cursor(_envelope((self.root / "manifest.ocdbt").read_bytes(),
                                MANIFEST_MAGIC, where), where)
        cur.take(16)                                    # uuid
        if cur.varint() != 0:
            cur.fail("a numbered manifest; only single manifests are read")
        cur.varint()                                    # max inline value
        cur.varint()                                    # max decoded node
        cur.u8()                                        # version arity log2
        if cur.varint() == 1:
            cur.take(4)                                 # zstd level, i32 LE
        files = _file_table(cur)
        n = cur.varint()
        if n == 0:
            self._root = None                           # an empty store
            return
        generation = cur.varints(n)
        height = list(cur.take(n))
        fid, offset, length = cur.varints(n), cur.varints(n), cur.varints(n)
        num_keys = cur.varints(n)
        cur.varints(2 * n)                              # tree, value bytes
        cur.take(8 * n)                                 # commit times
        newest = max(range(n), key=generation.__getitem__)
        if num_keys[newest] == 0:
            self._root = None                           # an empty tree
            return
        if fid[newest] >= len(files):
            cur.fail("root in a data file beyond the table")
        self._root = (files[fid[newest]], offset[newest], length[newest],
                      height[newest])

    def _read(self, path: str, offset: int, length: int) -> bytes:
        full = self.root / path
        with open(full, "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"{full}: {length} bytes at {offset} are past "
                             "its end")
        return data

    def _node(self, path, offset, length, height, prefix
              ) -> Iterator[Tuple[bytes, Tuple]]:
        where = f"{self.root / path} [{offset}:{offset + length}]"
        cur = _Cursor(_envelope(self._read(path, offset, length),
                                NODE_MAGIC, where), where)
        if cur.u8() != height:
            cur.fail(f"node height differs from its parent's {height}")
        files = _file_table(cur)
        n = cur.varint()
        keys, common = _keys(cur, n, height > 0)
        if height > 0:
            fid, off, size = cur.varints(n), cur.varints(n), cur.varints(n)
            cur.varints(3 * n)                          # subtree statistics
            cur.end()
            for i in range(n):
                if fid[i] >= len(files) or common[i] > len(keys[i]):
                    cur.fail(f"child {i} out of range")
                yield from self._node(files[fid[i]], off[i], size[i],
                                      height - 1,
                                      prefix + keys[i][:common[i]])
            return
        sizes = cur.varints(n)
        kinds = list(cur.take(n))
        if any(k > 1 for k in kinds):
            cur.fail("unknown value kind")
        indirect = [i for i in range(n) if kinds[i] == 1]
        fid, off = cur.varints(len(indirect)), cur.varints(len(indirect))
        refs = dict(zip(indirect, zip(fid, off)))
        for i in range(n):
            if i in refs:
                f, o = refs[i]
                if f >= len(files):
                    cur.fail(f"value {i} in a data file beyond the table")
                yield prefix + keys[i], ("file", files[f], o, sizes[i])
            else:
                yield prefix + keys[i], ("inline", cur.take(sizes[i]))
        cur.end()

    def refs(self) -> Dict[bytes, Tuple]:
        """Every key -> ("inline", bytes) or ("file", path, offset,
        length), in key order."""
        if self._root is None:
            return {}
        return dict(self._node(*self._root, b""))

    def value(self, ref: Tuple) -> bytes:
        return ref[1] if ref[0] == "inline" else self._read(*ref[1:])

    def items(self) -> Dict[bytes, bytes]:
        """Every key -> its value bytes."""
        return {k: self.value(r) for k, r in self.refs().items()}


def _zarr_dtype(name: str) -> Tuple[np.dtype, bool]:
    """(numpy dtype to read, whether it is bf16 kept in uint16)."""
    if name == "bfloat16":
        return np.dtype("<u2"), True
    return np.dtype(name), False


def read_zarr(reader: OcdbtReader, refs: Dict[bytes, Tuple], name: str
              ) -> np.ndarray:
    """The zarr v2 array ``name`` of an OCDBT store (bf16 widened to f32)."""
    meta_key = f"{name}/.zarray".encode()
    if meta_key not in refs:
        raise ValueError(f"{reader.root}: no array {name!r}")
    meta = json.loads(reader.value(refs[meta_key]))
    if meta.get("zarr_format") != 2 or meta.get("filters"):
        raise ValueError(f"{name}: zarr format {meta.get('zarr_format')} "
                         f"with filters {meta.get('filters')} is not read")
    dtype, bf16 = _zarr_dtype(meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    order = meta.get("order", "C")
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor not in (None, "zstd"):
        raise ValueError(f"{name}: compressor {compressor!r} is not read")
    sep = meta.get("dimension_separator", ".")
    fill = meta.get("fill_value")
    if fill is None:
        fill = 0
    elif bf16:
        fill = np.float32(fill).view(np.uint32) >> 16
    out = np.full(shape, fill, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = (sep.join(map(str, index)) if shape else "0")
        ref = refs.get(f"{name}/{key}".encode())
        if ref is None:
            continue                                    # the fill value
        raw = reader.value(ref)
        if compressor == "zstd":
            raw = decompress(raw)
        if len(raw) != dtype.itemsize * int(np.prod(chunks, dtype=np.int64)):
            raise ValueError(f"{name}/{key}: {len(raw)} bytes, want a "
                             f"chunk of {chunks} {dtype}")
        chunk = np.frombuffer(raw, dtype).reshape(chunks, order=order)
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(index, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    out = out.astype(dtype.newbyteorder("="), copy=False)
    if bf16:
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _insert(tree: Dict, path: List[Tuple[Any, int]], value):
    """Put ``value`` into the nested dict ``tree``, keyed by (key,
    key_type) until ``_freeze``."""
    node = tree
    for step in path[:-1]:
        node = node.setdefault(step, {})
    node[path[-1]] = value


def _freeze(node):
    if not isinstance(node, dict):
        return node
    kinds = {kind for _, kind in node}
    if kinds == {_KEY_SEQUENCE}:
        items = sorted(node.items(), key=lambda kv: int(kv[0][0]))
        return tuple(_freeze(v) for _, v in items)
    return {key: _freeze(v) for (key, _), v in node.items()}


def read_tree(directory) -> Dict[str, Any]:
    """The pytree of one orbax ``StandardSave`` item directory (``<step>/
    default``), leaves as numpy arrays or Python scalars."""
    directory = Path(directory)
    meta = json.loads((directory / "_METADATA").read_text())
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{directory}: only OCDBT + zarr v2 checkpoints "
                         "are read")
    reader = OcdbtReader(directory)
    refs = reader.refs()
    tree: Dict = {}
    for entry in meta["tree_metadata"].values():
        path = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
        if any(kind not in (_KEY_DICT, _KEY_SEQUENCE) for _, kind in path):
            raise ValueError(f"{directory}: key types of {path} not read")
        value_meta = entry["value_metadata"]
        kind = value_meta["value_type"]
        if value_meta.get("skip_deserialize"):
            if kind not in _EMPTY:
                raise ValueError(f"{directory}: {kind} leaves are not read")
            value = _EMPTY[kind]
        else:
            value = read_zarr(reader, refs, ".".join(k for k, _ in path))
            if kind == "scalar":
                value = value.item()
        _insert(tree, path, value)
    return _freeze(tree)


def is_orbax_directory(path) -> bool:
    """Whether ``path`` is a directory of orbax step checkpoints."""
    return bool(all_steps(path))


def all_steps(directory) -> List[int]:
    """The finished steps of an orbax ``CheckpointManager`` directory, in
    order (temporary ``*.orbax-checkpoint-tmp-*`` directories skipped)."""
    directory = Path(directory)
    if not directory.is_dir():
        return []
    return sorted(int(p.name) for p in directory.iterdir()
                  if _STEP.match(p.name) and p.is_dir()
                  and (p / "_CHECKPOINT_METADATA").exists())


def latest_step(directory) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def read_checkpoint(directory, step: Optional[int] = None
                    ) -> Dict[str, Any]:
    """A JAX ``CheckpointManager`` checkpoint (the latest step by default)
    -> {"params", "batch_stats", "opt_state", "step", and with SWA
    "swa_params", "swa_count", and "extra" where saved}."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no orbax checkpoint steps in {directory}")
    return read_tree(Path(directory) / str(step) / "default")


def load_hparams(directory, step: Optional[int] = None
                 ) -> Optional[Dict[str, Any]]:
    """The config saved beside a checkpoint (``hparams-<step>.json``, the
    latest step by default), or None."""
    step = latest_step(directory) if step is None else step
    if step is None:
        return None
    path = os.path.join(directory, f"hparams-{step}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
