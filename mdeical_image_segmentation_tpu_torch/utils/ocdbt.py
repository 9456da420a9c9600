"""A read-only reader of tensorstore's OCDBT key-value store (the
"Optionally-Cooperative Distributed B+Tree" orbax writes its checkpoints
into), without tensorstore: the card's machine has neither orbax nor
tensorstore.

A database is a directory holding ``manifest.ocdbt`` and data files under
``d/``.  Every manifest and B-tree node is a file part of this shape::

    magic      u32 big-endian  0x0cdb3a2a (manifest) or 0x0cdb20de (node)
    length     u64 le          of the whole part, checksum included
    version    varint          0
    compression varint         0 none, 1 zstd (the rest is one zstd frame)
    body       ...
    crc32c     u32 le          of every byte before it

All integers in a body are LEB128 varints unless said otherwise; arrays are
stored column by column.

- The manifest's body: the config (a 16-byte uuid, ``manifest_kind`` (0: the
  versions are in this file), ``max_inline_value_bytes``,
  ``max_decoded_node_bytes``, ``version_tree_arity_log2`` (u8),
  ``compression_method`` and, for zstd, its level as i32 le), a data file
  table, then the newest versions inline (``generation_number``,
  ``root_height`` (u8), the root's ``data_file_id``, ``offset``,
  ``length``, ``num_keys``, ``num_tree_bytes``,
  ``num_indirect_value_bytes``, ``commit_time`` (u64 le)), then references
  to older version tree nodes, which are not read: only the newest version
  (the largest generation number) is.
- A data file table: ``num_files``, ``path_prefix_length`` of files 1..n-1
  (bytes shared with the previous path), ``path_suffix_length``,
  ``base_path_length`` of each file, then the suffixes.  A path is relative
  to the database's directory (``ocdbt.process_<i>/d/...`` where orbax's
  root database points into a process's database).
- A B-tree node's body: ``height`` (u8), its own data file table, the
  entry count, ``key_prefix_length`` of entries 1..n-1 and
  ``key_suffix_length`` of each (keys shared with the previous entry's),
  then for an interior node (height > 0) each child's
  ``subtree_common_prefix_length``, the key suffixes, and each child's
  ``data_file_id``, ``offset``, ``length``, ``num_keys``,
  ``num_tree_bytes`` and ``num_indirect_value_bytes``; for a leaf the key
  suffixes, each value's length and kind (0 inline, 1 in a data file),
  ``data_file_id`` and ``offset`` of the out-of-line values, then the
  inline values back to back.  A child's keys omit the first
  ``subtree_common_prefix_length`` bytes of its entry's key, which every
  key below it shares.

Out-of-line values are bytes of a data file, read at their offset; they
carry no checksum of their own (a zarr chunk has its zstd frame's).
Anything else that does not hold (a magic number, a length, a checksum, a
version, a node's height, an offset past its file) raises ``OcdbtError``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Tuple

MANIFEST = "manifest.ocdbt"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
EMPTY = (1 << 64) - 1  # the offset and length of an empty tree's root


class OcdbtError(ValueError):
    pass


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC32C
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def fail(self, msg: str):
        raise OcdbtError(f"{self.what}: {msg}")

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data):
                self.fail("truncated varint")
            b = self.data[self.pos]
            self.pos += 1
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")
        if value >= 1 << 64:
            self.fail("varint longer than 64 bits")
        return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if n > len(self.data) - self.pos:
            self.fail(f"truncated: {n} bytes wanted, "
                      f"{len(self.data) - self.pos} left")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def end(self):
        if self.pos != len(self.data):
            self.fail(f"{len(self.data) - self.pos} bytes past the end")


def _unpack(data: bytes, magic: int, what: str) -> _Reader:
    """The body of one manifest or node part, its header and checksum
    checked and zstd undone."""
    from . import zstd

    if len(data) < 16:
        raise OcdbtError(f"{what}: {len(data)} bytes, too short")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from(
        "<Q", data, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{what}: magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(data):
        raise OcdbtError(f"{what}: header length {length}, {len(data)} read")
    want = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != want:
        raise OcdbtError(f"{what}: crc32c mismatch")
    r = _Reader(data[:-4], what)
    r.pos = 12
    version = r.varint()
    if version != 0:
        r.fail(f"format version {version} (0 is read)")
    compression = r.varint()
    body = data[r.pos:-4]
    if compression == 1:
        try:
            body = zstd.decompress(body)
        except ValueError as e:
            r.fail(f"zstd body: {e}")
    elif compression != 0:
        r.fail(f"compression format {compression} (0 or 1 is read)")
    return _Reader(body, what)


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail(f"data file {i}: prefix {prefix[i]} > {len(prev)}")
        path = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(path):
            r.fail(f"data file {i}: base path {base[i]} > {len(path)}")
        paths.append(path.decode())
        prev = path
    return paths


def _keys(r: _Reader, n: int, with_common: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if with_common else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail(f"key {i}: prefix {prefix[i]} > {len(prev)}")
        prev = prev[:prefix[i]] + r.take(suffix[i])
        keys.append(prev)
    if with_common:
        for i, c in enumerate(common):
            if c > len(keys[i]):
                r.fail(f"key {i}: common prefix {c} > {len(keys[i])}")
    return keys, common


# a value: bytes inline, or (path, offset, length) in a data file
Ref = Tuple[str, int, int]


class KvStore:
    """The newest version of the OCDBT database in ``root``:
    ``list()`` gives its keys in order, ``read(key)`` a value."""

    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, MANIFEST)
        if not os.path.exists(path):
            raise OcdbtError(f"no {MANIFEST} in '{root}'")
        with open(path, "rb") as f:
            r = _unpack(f.read(), MANIFEST_MAGIC, path)
        self.config = self._config(r)
        files = _data_file_table(r)
        n = r.varint()
        gen = r.varints(n)
        height = [r.u8() for _ in range(n)]
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        num_keys = r.varints(n)
        r.varints(2 * n)  # num_tree_bytes, num_indirect_value_bytes
        r.take(8 * n)  # commit times
        if not n:
            r.fail("no version")
        i = max(range(n), key=gen.__getitem__)
        self._index: Dict[bytes, object] = {}
        if offset[i] != EMPTY:
            if file_id[i] >= len(files):
                r.fail(f"root in data file {file_id[i]} of {len(files)}")
            self._walk((files[file_id[i]], offset[i], length[i]),
                       height[i], b"")
        if len(self._index) != num_keys[i]:
            raise OcdbtError(f"{path}: {len(self._index)} keys found, the "
                             f"manifest says {num_keys[i]}")

    @staticmethod
    def _config(r: _Reader) -> dict:
        config = {"uuid": r.take(16).hex(), "manifest_kind": r.varint(),
                  "max_inline_value_bytes": r.varint(),
                  "max_decoded_node_bytes": r.varint(),
                  "version_tree_arity_log2": r.u8(),
                  "compression_method": r.varint()}
        if config["manifest_kind"] != 0:
            r.fail("a numbered manifest (manifest_kind 1) is not read "
                   "(ROADMAP item 19b)")
        if config["compression_method"] == 1:
            config["zstd_level"] = struct.unpack("<i", r.take(4))[0]
        elif config["compression_method"] != 0:
            r.fail(f"compression method {config['compression_method']}")
        return config

    def _bytes(self, ref: Ref) -> bytes:
        path, offset, length = ref
        full = os.path.join(self.root, path)
        try:
            size = os.path.getsize(full)
        except OSError as e:
            raise OcdbtError(f"data file '{full}': {e}") from None
        if offset + length > size:
            raise OcdbtError(f"data file '{full}': bytes {offset}+{length} "
                             f"past its {size}")
        with open(full, "rb") as f:
            f.seek(offset)
            return f.read(length)

    def _walk(self, ref: Ref, height: int, prefix: bytes) -> None:
        what = f"node {ref[0]}@{ref[1]}"
        r = _unpack(self._bytes(ref), NODE_MAGIC, what)
        got = r.u8()
        if got != height:
            r.fail(f"height {got}, its parent says {height}")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, with_common=height > 0)

        def file_of(i: int) -> str:
            if i >= len(files):
                r.fail(f"data file {i} of {len(files)}")
            return files[i]

        if height > 0:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # num_keys, num_tree_bytes, indirect bytes
            r.end()
            for i in range(n):
                self._walk((file_of(ids[i]), offs[i], lens[i]), height - 1,
                           prefix + keys[i][:common[i]])
            return
        lens = r.varints(n)
        kinds = r.varints(n)
        if any(k > 1 for k in kinds):
            r.fail(f"value kinds {sorted(set(kinds))} (0 or 1 is read)")
        outside = [i for i in range(n) if kinds[i] == 1]
        ids, offs = r.varints(len(outside)), r.varints(len(outside))
        refs = dict(zip(outside, zip(ids, offs)))
        for i in range(n):
            key = prefix + keys[i]
            if key in self._index:
                r.fail(f"key {key!r} twice")
            if i in refs:
                fid, off = refs[i]
                self._index[key] = (file_of(fid), off, lens[i])
            else:
                self._index[key] = r.take(lens[i])
        r.end()

    def list(self) -> List[bytes]:
        return sorted(self._index)

    def read(self, key) -> bytes:
        if isinstance(key, str):
            key = key.encode()
        value = self._index[key]
        return value if isinstance(value, bytes) else self._bytes(value)

    def __contains__(self, key) -> bool:
        return (key.encode() if isinstance(key, str) else key) in self._index
