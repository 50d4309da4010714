"""The port's zstd decoder (utils/csrc/zstd_decode.cpp via utils/zstd.py)
against the ``zstandard`` module, which only the tests import.

Levels -5 (fast, no Huffman literals), 1, 3, 9, 19 and 22 (ultra) over
empty, RLE-heavy, random and f32-weight-like buffers; frames without a
content size (streamed, and flushed block by block), concatenated and
skippable frames, checksummed frames, a multi-MB input with a long window
and long-distance matching (matches reaching back over many blocks, repeat
offsets); and malformed input: truncated frames, flipped bytes, a
dictionary ID, which raise ValueError with the offset.
"""
import numpy as np
import pytest
import zstandard

from temporalstereo_tpu_torch.data import native
from temporalstereo_tpu_torch.utils import zstd

LEVELS = (-5, 1, 3, 9, 19, 22)


def _buffers():
    rng = np.random.RandomState(11)
    weights = (rng.randn(256 * 1024) * 0.02).astype(np.float32)
    return {
        "empty": b"",
        "rle": b"\x00" * 70000 + b"ab" * 20000 + b"\xff" * 3,
        "random": rng.bytes(150000),
        "weights": weights.tobytes(),
        "text": b"".join(b"step %d loss %.4f epe %.3f\n" % (i, 1 / (i + 1),
                                                            i % 7 / 3)
                         for i in range(8000)),
    }


BUFFERS = _buffers()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(BUFFERS))
def test_decodes_zstandard_frames(name, level):
    data = BUFFERS[name]
    for kw in ({}, {"write_checksum": True, "write_content_size": False}):
        frame = zstandard.ZstdCompressor(level=level, **kw).compress(data)
        assert zstd.decompress(frame) == data, kw


def test_streamed_concatenated_and_skippable_frames():
    weights = BUFFERS["weights"]
    comp = zstandard.ZstdCompressor(level=3, write_checksum=True)
    obj = comp.compressobj()
    streamed = (obj.compress(weights[:300000])
                + obj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                + obj.compress(weights[300000:]) + obj.flush())
    assert zstd.decompress(streamed) == weights
    skippable = b"\x5a\x2a\x4d\x18" + (6).to_bytes(4, "little") + b"ignore"
    parts = [b"first", b"", BUFFERS["text"][:5000]]
    joined = (zstandard.ZstdCompressor(level=1).compress(parts[0])
              + skippable
              + zstandard.ZstdCompressor(level=19).compress(parts[1])
              + zstandard.ZstdCompressor(level=-5).compress(parts[2])
              + skippable)
    assert zstd.decompress(joined) == b"".join(parts)


def test_long_window_and_long_distance_matches():
    """Several MB whose repeats lie megabytes back: the window and the
    matches span many 128 KiB blocks."""
    rng = np.random.RandomState(12)
    block = (rng.randn(600000) * 0.1).astype(np.float32).tobytes()
    data = block + rng.bytes(500000) + block[:1500000] + block[100:900000]
    params = zstandard.ZstdCompressionParameters.from_level(
        19, window_log=24, enable_ldm=True, write_checksum=True)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert len(frame) < 0.7 * len(data)
    assert zstd.decompress(frame) == data


def test_malformed_input_raises_with_the_offset():
    data = BUFFERS["text"][:20000] + BUFFERS["weights"][:20000]
    frame = zstandard.ZstdCompressor(level=9, write_checksum=True
                                     ).compress(data)
    for cut in (0, 3, 4, 5, 8, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError, match="at byte"):
            zstd.decompress(frame[:cut])
    rng = np.random.RandomState(13)
    for at in rng.choice(len(frame), 40, replace=False):
        bad = bytearray(frame)
        bad[at] ^= 1 << rng.randint(8)
        with pytest.raises(ValueError, match="zstd: "):
            zstd.decompress(bytes(bad))
    with pytest.raises(ValueError, match="not a zstd frame at byte 0"):
        zstd.decompress(b"PK\x03\x04" + frame)
    samples = [b"step %d loss %.3f" % (i, i / 7) for i in range(400)]
    trained = zstandard.train_dictionary(2048, samples)
    assert trained.dict_id()
    with_dict = zstandard.ZstdCompressor(dict_data=trained, level=3
                                         ).compress(samples[5])
    with pytest.raises(ValueError, match="dictionar"):
        zstd.decompress(with_dict)


def test_crc32c():
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(b"123456789") == 0xE3069283      # the check value
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA           # RFC 3720 B.4


def test_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    """A decoder source that does not compile raises with g++'s message:
    there is no fallback."""
    bad = tmp_path / "zstd_decode.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native.build(bad, "tszstd")
    assert not list((tmp_path / "build").glob("*.so"))
