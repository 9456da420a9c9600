"""The port's zstd decoder (``utils/zstd.py`` over
``csrc/zstd_decompress.c``) against tensorstore and the ``zstandard``
module (libzstd), which write the frames the orbax reader meets, to the
byte.

- The committed frames (``tests/fixtures/orbax/zstd``, written by
  tensorstore's zarr driver: a 256 KiB chunk at levels 1, 3, 9 and 19,
  a constant chunk, a random one, float weights) decode to the length and
  SHA-256 of tensorstore's read in ``manifest.json``.
- Chunks tensorstore's zarr driver writes here at levels 1, 3, 9 and 19
  equal tensorstore's read of them.
- Frames libzstd writes, for each part of the format on its own: with and
  without the content size and the checksum, single-segment and windowed
  headers at several window sizes, raw, RLE and compressed blocks,
  Huffman literals in 1 and 4 streams and reused tables, every sequence
  table mode, matches that overlap their source, several frames and
  skippable frames back to back, negative and ultra levels.
- Corrupt input raises ``ValueError``: a truncated frame, a dictionary
  ID, a wrong content size, a reserved bit, an unknown magic number, a
  flipped bit under a checksum (unless the bit is padding the decoding
  never reads, and the content comes back whole).  Without a checksum a
  flipped bit gives a ``ValueError`` or bytes, never a fault.
"""

import hashlib
import json
import os
import random

import numpy as np
import pytest
import tensorstore as ts
import zstandard

from mdeical_image_segmentation_tpu_torch.utils import zstd

HERE = os.path.dirname(os.path.abspath(__file__))
ORBAX = os.path.join(HERE, "fixtures", "orbax")


def _manifest():
    with open(os.path.join(HERE, "fixtures", "manifest.json")) as f:
        return json.load(f)["orbax"]


FRAMES = sorted(_manifest()["zstd"])


def _text():
    with open(os.path.join(HERE, "..", "mdeical_image_segmentation_tpu_torch",
                           "train", "trainer3d.py"), "rb") as f:
        return f.read()


def _data(kind: str) -> bytes:
    rng = np.random.default_rng(7)
    return {
        "empty": b"",
        "one": b"x",
        "text": _text(),
        "text_x6": _text() * 6,  # several 128 KiB blocks, long matches
        "zeros": bytes(300_000),  # RLE blocks
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "weights": (rng.standard_normal(60_000) * 0.02).astype(
            np.float32).tobytes(),
        "small_ints": rng.integers(0, 5, 50_000).astype(np.int64).tobytes(),
        "runs": b"".join(bytes([i % 7]) * (1 + i % 40) for i in range(9000)),
        # matches whose offset is shorter than their length
        "period3": b"abc" * 50_000,
    }[kind]


KINDS = ("empty", "one", "text", "text_x6", "zeros", "random", "weights",
         "small_ints", "runs", "period3")


@pytest.mark.parametrize("name", FRAMES)
def test_committed_frames_match_tensorstores_read(name):
    want = _manifest()["zstd"][name]
    with open(os.path.join(ORBAX, name), "rb") as f:
        out = zstd.decompress(f.read())
    assert len(out) == want["length"]
    assert hashlib.sha256(out).hexdigest() == want["sha256"]


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_tensorstore_zarr_chunks_at_each_level(tmp_path, level):
    rng = np.random.default_rng(level)
    cases = {
        "big": np.repeat(rng.integers(0, 90, 12_000), 7).astype(np.int32),
        "weights": (rng.standard_normal(30_000) * 0.1).astype(np.float32),
        "const": np.full(50_000, -2.5, np.float64),
        "bool": rng.random(40_000) > 0.3,
    }
    for name, data in cases.items():
        path = tmp_path / name
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{path}",
                       "metadata": {"compressor": {"id": "zstd",
                                                   "level": level},
                                    "shape": list(data.shape),
                                    "chunks": list(data.shape),
                                    "dtype": data.dtype.str}},
                      create=True).result()
        arr.write(data).result()
        want = np.ascontiguousarray(np.asarray(arr.read().result()))
        got = zstd.decompress((path / "0").read_bytes())
        assert got == want.tobytes(), name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("level", [-5, 1, 3, 9, 19, 22])
def test_libzstd_frames(kind, level):
    data = _data(kind)
    for kw in ({}, {"write_checksum": True}, {"write_content_size": False}):
        frame = zstandard.ZstdCompressor(level=level, **kw).compress(data)
        assert zstd.decompress(frame) == data, kw


@pytest.mark.parametrize("window_log", [10, 12, 17, 20, 23, 27])
def test_windowed_streamed_frames(window_log):
    """Frames a streaming compressor writes: no content size, a window
    descriptor, blocks flushed at uneven points."""
    data = _data("text_x6") + _data("small_ints")[:100_000]
    params = zstandard.ZstdCompressionParameters.from_level(
        9, window_log=window_log)
    c = zstandard.ZstdCompressor(compression_params=params)
    obj = c.compressobj()
    frame, i, step = b"", 0, 1
    while i < len(data):
        frame += obj.compress(data[i:i + step])
        frame += obj.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
        i += step
        step = step * 3 + 1
    frame += obj.flush()
    assert zstd.decompress(frame) == data


def test_frames_and_skippable_frames_back_to_back():
    parts = [_data("text"), _data("zeros")[:1000], _data("runs"), b""]
    skip = (0x184D2A5B).to_bytes(4, "little") + (6).to_bytes(4, "little")
    stream = b""
    for i, p in enumerate(parts):
        stream += zstandard.ZstdCompressor(
            level=3 + i, write_checksum=bool(i % 2)).compress(p)
        stream += skip + b"ignore"
    assert zstd.decompress(stream) == b"".join(parts)


def _frame(data=None, **kw):
    data = _data("text") if data is None else data
    return zstandard.ZstdCompressor(level=9, **kw).compress(data)


def test_dictionary_frames_raise():
    samples = [_data("text")[i:i + 300] for i in range(0, 60_000, 300)]
    d = zstandard.train_dictionary(4096, samples)
    frame = zstandard.ZstdCompressor(dict_data=d).compress(_data("text"))
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)


@pytest.mark.parametrize("cut", [0.0, 0.1, 0.5, 0.9, 0.999])
def test_truncated_frames_raise(cut):
    frame = _frame(write_checksum=True)
    with pytest.raises(ValueError):
        zstd.decompress(frame[:int(len(frame) * cut)])


def test_header_errors_raise():
    frame = bytearray(_frame())
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(b"\x00" + bytes(frame[1:]))
    reserved = bytearray(frame)
    reserved[4] |= 0x08
    with pytest.raises(ValueError, match="reserved"):
        zstd.decompress(bytes(reserved))
    # a frame whose stated content size is one byte short of its blocks
    data = _data("text")
    sized = zstandard.ZstdCompressor(level=1).compress(data)
    header = zstandard.get_frame_parameters(sized)
    assert header.content_size == len(data)
    fhd = sized[4]
    size_bytes = {0: 1, 1: 2, 2: 4, 3: 8}[fhd >> 6]
    start = 5 + (0 if fhd & 0x20 else 1)
    stated = int.from_bytes(sized[start:start + size_bytes], "little")
    short = (sized[:start] + (stated - 1).to_bytes(size_bytes, "little")
             + sized[start + size_bytes:])
    with pytest.raises(ValueError, match="content size"):
        zstd.decompress(short)


def test_checksum_lets_no_changed_content_through():
    """Under a checksum a flipped bit raises, or is one the decoding does
    not read (padding, libzstd gives the same bytes) and the content comes
    back whole."""
    data = _data("runs")
    frame = _frame(data=data, write_checksum=True)
    rng = random.Random(3)
    raised = 0
    for _ in range(150):
        b = bytearray(frame)
        b[rng.randrange(6, len(b))] ^= 1 << rng.randrange(8)
        try:
            out = zstd.decompress(bytes(b))
        except ValueError:
            raised += 1
            continue
        assert out == data
        assert zstandard.ZstdDecompressor().decompress(bytes(b)) == data
    assert raised >= 140


@pytest.mark.parametrize("seed", range(4))
def test_corrupt_frames_raise_or_decode_without_fault(seed):
    """Flipped bits, inserted and dropped bytes in frames without a
    checksum: a ValueError or some bytes, never a crash or a read or
    write out of bounds (the decoder checks every read and write)."""
    rng = random.Random(seed)
    frames = [_frame(data=_data(k)) for k in ("text", "weights", "runs",
                                                "period3")]
    for _ in range(300):
        b = bytearray(rng.choice(frames))
        op = rng.randrange(3)
        i = rng.randrange(len(b))
        if op == 0:
            b[i] ^= 1 << rng.randrange(8)
        elif op == 1:
            del b[i:i + rng.randint(1, 8)]
        else:
            b[i:i] = bytes(rng.randrange(256) for _ in range(4))
        try:
            out = zstd.decompress(bytes(b))
        except ValueError:
            continue
        assert isinstance(out, bytes)
