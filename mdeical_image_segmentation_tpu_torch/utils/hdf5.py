"""A small HDF5 codec on the standard library, numpy and ``zlib``.

The machine with the card has no h5py, and the volumetric pipeline reads
its volumes from HDF5 files and writes its predictions into one.  This
module covers the part of h5py's API that pipeline uses:

- ``File(path, "r" | "w")`` as a context manager; for reading
  ``f["a/b"]``, ``key in f`` and ``keys()``;
- ``Dataset.shape``, ``.dtype``, ``.ndim``, ``.chunks``, ``.compression``,
  ``ds[:]`` and ``ds[index]`` with ints and slices, reading only the chunks
  the index touches;
- ``File.create_dataset(name, data=..., compression="gzip")``.

What it reads is the file h5py writes by default: superblock version 0,
version-1 object headers, symbol-table groups (a version-1 B-tree of
symbol-table nodes plus a local heap) nested to any depth, contiguous,
compact and chunked layouts (a version-1 B-tree of any depth), the deflate
and shuffle filters, and little- or big-endian integers of 1-8 bytes and
IEEE floats of 4 and 8 bytes.  Anything else (a ``libver="latest"`` file,
another filter, a compound or string type, a soft link) raises and names
what it found.

What it writes: superblock version 0 and symbol-table groups; each dataset
contiguous, or, with ``compression="gzip"``, chunked (h5py's chunk guess)
through deflate at level 4, h5py's default.
"""

from __future__ import annotations

import itertools
import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x1, 0x2, 0x3
MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x5, 0x6, 0x7, 0x8
MSG_FILTERS = 0xB
MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x10, 0x11

FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
GROUP_LEAF_K, GROUP_NODE_K, CHUNK_K = 4, 16, 32  # the library's defaults
GZIP_LEVEL = 4


class HDF5Error(ValueError):
    """A file this codec does not read, or a malformed one."""


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    """Little-endian fields at absolute addresses of an open file."""

    def __init__(self, path: str):
        self.path = path
        self.fd = os.open(path, os.O_RDONLY)

    def close(self) -> None:
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self.fd, n, addr)
        if len(data) != n:
            raise HDF5Error(f"{self.path}: {n} bytes at {addr} run past the "
                            "end of the file")
        return data


def _parse_datatype(b: bytes) -> np.dtype:
    cls, version = b[0] & 0x0F, b[0] >> 4
    bits = b[1] | (b[2] << 8) | (b[3] << 16)
    size = struct.unpack_from("<I", b, 4)[0]
    order = ">" if bits & 1 else "<"
    if version != 1:
        raise HDF5Error(f"datatype message version {version} not supported")
    if cls == 0:  # fixed-point
        if size not in (1, 2, 4, 8):
            raise HDF5Error(f"integer of {size} bytes not supported")
        return np.dtype(f"{order}{'i' if bits & 0x8 else 'u'}{size}")
    if cls == 1:  # floating point
        if bits & 0x40:
            raise HDF5Error("VAX-order floats not supported")
        offset, precision, e_loc, e_size, m_loc, m_size, bias = struct.unpack_from(
            "<HHBBBBI", b, 8)
        sign = (bits >> 8) & 0xFF
        ieee = {4: (31, 23, 8, 0, 23, 127), 8: (63, 52, 11, 0, 52, 1023)}
        if (size not in ieee or offset != 0 or precision != 8 * size
                or (sign, e_loc, e_size, m_loc, m_size, bias) != ieee[size]):
            raise HDF5Error(f"float of {size} bytes with layout "
                            f"{(sign, e_loc, e_size, m_loc, m_size, bias)} is "
                            "not IEEE single or double")
        return np.dtype(f"{order}f{size}")
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
             6: "compound", 7: "reference", 8: "enum", 9: "variable-length",
             10: "array"}
    raise HDF5Error(f"datatype class {names.get(cls, cls)} not supported")


def _parse_dataspace(b: bytes) -> Tuple[int, ...]:
    version, rank, flags = b[0], b[1], b[2]
    if version != 1:
        raise HDF5Error(f"dataspace message version {version} not supported")
    return struct.unpack_from(f"<{rank}Q", b, 8)


def _parse_filters(b: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
    version, n = b[0], b[1]
    if version != 1:
        raise HDF5Error(f"filter pipeline message version {version} not "
                        "supported")
    pos, out = 8, []
    for _ in range(n):
        fid, name_len, _flags, n_vals = struct.unpack_from("<HHHH", b, pos)
        pos += 8 + name_len
        vals = struct.unpack_from(f"<{n_vals}I", b, pos)
        pos += 4 * n_vals + (4 if n_vals % 2 else 0)
        if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
            raise HDF5Error(f"filter {fid} not supported (deflate and "
                            "shuffle are)")
        out.append((fid, vals))
    return out


def _parse_fill(b: bytes) -> Optional[bytes]:
    """The fill value's bytes, or None for the default (zeros)."""
    version = b[0]
    if version in (1, 2):
        defined = b[3]
        if version == 1 or defined:
            size = struct.unpack_from("<I", b, 4)[0]
            return b[8:8 + size] if size else None
        return None
    if version == 3:
        flags = b[1]
        if flags & 0x20:
            size = struct.unpack_from("<I", b, 2)[0]
            return b[6:6 + size] if size else None
        return None
    raise HDF5Error(f"fill value message version {version} not supported")


class _ObjectHeader:
    """The messages of a version-1 object header, continuations followed."""

    def __init__(self, reader: _Reader, addr: int):
        head = reader.read(addr, 16)
        version, _, n_msgs, _, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise HDF5Error(f"object header version {version} at {addr} not "
                            "supported (a libver='latest' file?)")
        self.messages: List[Tuple[int, int, bytes]] = []
        blocks = [(addr + 16, size)]
        while blocks and len(self.messages) < n_msgs:
            start, length = blocks.pop(0)
            block = reader.read(start, length)
            pos = 0
            while pos + 8 <= length and len(self.messages) < n_msgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", block, pos)
                data = block[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                if mflags & 0x2:
                    raise HDF5Error(f"shared message of type {mtype} not "
                                    "supported")
                self.messages.append((mtype, mflags, data))

    def find(self, mtype: int) -> Optional[bytes]:
        for t, _, data in self.messages:
            if t == mtype:
                return data
        return None

    def types(self) -> set:
        return {t for t, _, _ in self.messages}


class Dataset:
    """An HDF5 dataset of a file open for reading."""

    def __init__(self, reader: _Reader, header: _ObjectHeader, name: str):
        self._reader, self.name = reader, name
        if MSG_EXTERNAL in header.types():
            raise HDF5Error(f"{name}: external storage not supported")
        self.shape = _parse_dataspace(header.find(MSG_DATASPACE))
        self.dtype = _parse_datatype(header.find(MSG_DATATYPE))
        fill = header.find(MSG_FILL)
        fill = None if fill is None else _parse_fill(fill)
        self._fill = (np.frombuffer(fill, self.dtype)[0] if fill is not None
                      and len(fill) == self.dtype.itemsize else 0)
        filters = header.find(MSG_FILTERS)
        self._filters = _parse_filters(filters) if filters else []
        layout = header.find(MSG_LAYOUT)
        if layout is None or layout[0] != 3:
            raise HDF5Error(f"{name}: data layout message version "
                            f"{None if layout is None else layout[0]} not "
                            "supported")
        self._layout_class = layout[1]
        self.chunks: Optional[Tuple[int, ...]] = None
        if self._layout_class == 0:  # compact
            size = struct.unpack_from("<H", layout, 2)[0]
            self._compact = layout[4:4 + size]
        elif self._layout_class == 1:  # contiguous
            self._addr = struct.unpack_from("<Q", layout, 2)[0]
        elif self._layout_class == 2:  # chunked
            rank = layout[2]
            self._addr = struct.unpack_from("<Q", layout, 3)[0]
            dims = struct.unpack_from(f"<{rank}I", layout, 11)
            self.chunks = tuple(dims[:-1])
            self._index: Optional[Dict[Tuple[int, ...], Tuple[int, int, int]]] = None
        else:
            raise HDF5Error(f"{name}: layout class {self._layout_class} not "
                            "supported")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def compression(self) -> Optional[str]:
        return ("gzip" if any(f == FILTER_DEFLATE for f, _ in self._filters)
                else None)

    @property
    def compression_opts(self) -> Optional[int]:
        for fid, vals in self._filters:
            if fid == FILTER_DEFLATE:
                return vals[0] if vals else None
        return None

    @property
    def shuffle(self) -> bool:
        return any(f == FILTER_SHUFFLE for f, _ in self._filters)

    def __getitem__(self, index) -> np.ndarray:
        box, post = _normalize_index(index, self.shape)
        return self._read_box(box)[post]

    # -- storage -------------------------------------------------------------

    def _read_box(self, box: Sequence[Tuple[int, int]]) -> np.ndarray:
        """The hyperslab [start, stop) per axis."""
        shape = tuple(b - a for a, b in box)
        sel = tuple(slice(a, b) for a, b in box)
        if self._layout_class == 0:
            full = np.frombuffer(self._compact, self.dtype)
            return full[:self.size].reshape(self.shape)[sel].copy()
        if self._layout_class == 1:
            if self._addr == UNDEF:
                return np.full(shape, self._fill, self.dtype)
            mm = np.memmap(self._reader.path, dtype=self.dtype, mode="r",
                           offset=self._addr, shape=self.shape)
            out = np.array(mm[sel])
            del mm
            return out
        return self._read_chunked(box, shape)

    def _chunk_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        """{chunk offset: (address, stored size, filter mask)}, from the
        version-1 B-tree, read once."""
        if self._index is None:
            index: Dict[Tuple[int, ...], Tuple[int, int, int]] = {}
            if self._addr != UNDEF:
                rank = len(self.shape) + 1
                for key, child in _btree_entries(self._reader, self._addr, 1,
                                                 rank):
                    size, mask = struct.unpack_from("<II", key)
                    offset = struct.unpack_from(f"<{rank}Q", key, 8)[:-1]
                    index[offset] = (child, size, mask)
            self._index = index
        return self._index

    def _decode_chunk(self, addr: int, size: int, mask: int) -> np.ndarray:
        data = self._reader.read(addr, size)
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue  # this filter was skipped for this chunk
            fid, _ = self._filters[i]
            if fid == FILTER_DEFLATE:
                data = zlib.decompress(data)
            else:
                data = _unshuffle(data, self.dtype.itemsize)
        n = int(np.prod(self.chunks))
        arr = np.frombuffer(data, self.dtype, count=n)
        return arr.reshape(self.chunks)

    def _read_chunked(self, box, shape) -> np.ndarray:
        out = np.full(shape, self._fill, self.dtype)
        if 0 in shape:
            return out
        index = self._chunk_index()
        ranges = [range(a // c, (b - 1) // c + 1)
                  for (a, b), c in zip(box, self.chunks)]
        for pos in itertools.product(*ranges):
            offset = tuple(p * c for p, c in zip(pos, self.chunks))
            entry = index.get(offset)
            if entry is None:
                continue  # never written: the fill value
            chunk = self._decode_chunk(*entry)
            src, dst = [], []
            for (a, b), o, c in zip(box, offset, self.chunks):
                lo, hi = max(a, o), min(b, o + c)
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = chunk[tuple(src)]
        return out


def _unshuffle(data: bytes, itemsize: int) -> bytes:
    if itemsize == 1:
        return data
    n = len(data) // itemsize
    head = np.frombuffer(data, np.uint8, count=n * itemsize)
    out = head.reshape(itemsize, n).T.tobytes()
    return out + data[n * itemsize:]


def _normalize_index(index, shape):
    """A bounding box [start, stop) per axis and the numpy index that takes
    the request out of it (steps, dropped int axes)."""
    if not isinstance(index, tuple):
        index = (index,)
    if any(i is Ellipsis for i in index):
        at = [k for k, i in enumerate(index) if i is Ellipsis]
        if len(at) > 1:
            raise IndexError("an index can only have a single ellipsis")
        k = at[0]
        fill = (slice(None),) * (len(shape) - len(index) + 1)
        index = index[:k] + fill + index[k + 1:]
    if len(index) > len(shape):
        raise IndexError(f"too many indices ({len(index)}) for a dataset of "
                         f"rank {len(shape)}")
    index = index + (slice(None),) * (len(shape) - len(index))
    box, post = [], []
    for i, n in zip(index, shape):
        if isinstance(i, slice):
            start, stop, step = i.indices(n)
            if step <= 0:
                raise IndexError("slice steps must be positive")
            if stop <= start:
                box.append((0, 0))
                post.append(slice(None))
            else:
                box.append((start, stop))
                post.append(slice(None, None, step))
        elif isinstance(i, (int, np.integer)):
            j = int(i) + n if i < 0 else int(i)
            if not 0 <= j < n:
                raise IndexError(f"index {i} out of range for axis of {n}")
            box.append((j, j + 1))
            post.append(0)
        else:
            raise TypeError(f"index {i!r}: ints, slices and ... only")
    return box, tuple(post)


def _btree_entries(reader: _Reader, addr: int, node_type: int,
                   rank: int = 0) -> Iterator[Tuple[bytes, int]]:
    """(left key, child address) of every leaf entry of a version-1 B-tree,
    any depth."""
    key_size = 8 if node_type == 0 else 8 + 8 * rank
    head = reader.read(addr, 24)
    if head[:4] != b"TREE":
        raise HDF5Error(f"no B-tree node at {addr}")
    ntype, level, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
    if ntype != node_type:
        raise HDF5Error(f"B-tree node of type {ntype} at {addr}, want "
                        f"{node_type}")
    body = reader.read(addr + 24, used * (key_size + 8) + key_size)
    for i in range(used):
        pos = i * (key_size + 8)
        key = body[pos:pos + key_size]
        child = struct.unpack_from("<Q", body, pos + key_size)[0]
        if level == 0:
            yield key, child
        else:
            yield from _btree_entries(reader, child, node_type, rank)


class Group:
    """A symbol-table group of a file open for reading."""

    def __init__(self, reader: _Reader, header: _ObjectHeader, name: str):
        self._reader, self.name = reader, name
        stab = header.find(MSG_SYMBOL_TABLE)
        if stab is None:
            kind = ("link messages (a libver='latest' group)"
                    if header.types() & {MSG_LINK, MSG_LINK_INFO}
                    else "no symbol table")
            raise HDF5Error(f"group {name}: {kind} not supported")
        btree, heap = struct.unpack_from("<QQ", stab)
        self._links = _read_symbol_table(reader, btree, heap, name)

    def keys(self) -> List[str]:
        return list(self._links)

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        node = self
        parts = [p for p in path.split("/") if p]
        for part in parts:
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f"no object {path!r} in {self.name!r}")
            node = node._open(part)
        return node

    def _open(self, name: str):
        full = f"{self.name.rstrip('/')}/{name}"
        header = _ObjectHeader(self._reader, self._links[name])
        types = header.types()
        if MSG_SYMBOL_TABLE in types or MSG_LINK_INFO in types:
            return Group(self._reader, header, full)
        if MSG_LAYOUT in types:
            return Dataset(self._reader, header, full)
        raise HDF5Error(f"{full}: object with messages {sorted(types)} is "
                        "neither a group nor a dataset")


def _read_symbol_table(reader: _Reader, btree: int, heap: int,
                       name: str) -> Dict[str, int]:
    head = reader.read(heap, 32)
    if head[:4] != b"HEAP":
        raise HDF5Error(f"group {name}: no local heap at {heap}")
    heap_size, _, heap_data = struct.unpack_from("<QQQ", head, 8)
    names = reader.read(heap_data, heap_size)
    links: Dict[str, int] = {}
    for _, snod in _btree_entries(reader, btree, 0):
        node = reader.read(snod, 8)
        if node[:4] != b"SNOD":
            raise HDF5Error(f"group {name}: no symbol table node at {snod}")
        count = struct.unpack_from("<H", node, 6)[0]
        entries = reader.read(snod + 8, 40 * count)
        for i in range(count):
            name_off, obj, cache = struct.unpack_from("<QQI", entries, 40 * i)
            if cache == 2:
                raise HDF5Error(f"group {name}: soft links not supported")
            end = names.index(b"\0", name_off)
            links[names[name_off:end].decode("utf-8")] = obj
    return links


class File(Group):
    """An HDF5 file: ``"r"`` to read, ``"w"`` to create (truncating)."""

    def __init__(self, path, mode: str = "r"):
        self.path, self.mode = os.fspath(path), mode
        self._reader: Optional[_Reader] = None
        self._writer: Optional[_Writer] = None
        if mode == "r":
            self._open_read()
        elif mode == "w":
            self._writer = _Writer(self.path)
            self.name = "/"
        else:
            raise ValueError(f"mode {mode!r}: 'r' or 'w' (in-place appends "
                             "are not supported)")

    def _open_read(self) -> None:
        reader = _Reader(self.path)
        try:
            sb = reader.read(0, 96)
            if sb[:8] != SIGNATURE:
                raise HDF5Error(f"{self.path}: not an HDF5 file (no "
                                "signature at offset 0)")
            if sb[8] != 0:
                raise HDF5Error(f"{self.path}: superblock version {sb[8]} not "
                                "supported (version 0 is; libver='latest' "
                                "files are not)")
            if sb[13] != 8 or sb[14] != 8:
                raise HDF5Error(f"{self.path}: offsets of {sb[13]} and "
                                f"lengths of {sb[14]} bytes not supported")
            base = struct.unpack_from("<Q", sb, 24)[0]
            if base != 0:
                raise HDF5Error(f"{self.path}: base address {base} not "
                                "supported")
            root = struct.unpack_from("<Q", sb, 56 + 8)[0]
            super().__init__(reader, _ObjectHeader(reader, root), "/")
        except BaseException:
            reader.close()
            raise
        self._reader = reader

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._reader is not None:
            self._reader.close()
            self._reader = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __getitem__(self, path: str):
        if self._writer is not None:
            raise ValueError("a file open for writing is not read back")
        return super().__getitem__(path)

    def __contains__(self, path: str) -> bool:
        if self._writer is not None:
            raise ValueError("a file open for writing is not read back")
        return super().__contains__(path)

    def create_dataset(self, name: str, data=None, *,
                       compression: Optional[str] = None):
        """Write ``data`` (an array) under ``name``, making the groups on
        its path: contiguous, or with ``compression="gzip"`` chunked (h5py's
        chunk guess) through deflate at level 4, h5py's default."""
        if self._writer is None:
            raise ValueError(f"{self.path} is not open for writing")
        if data is None:
            raise ValueError("create_dataset needs data")
        if compression not in (None, "gzip"):
            raise ValueError(f"compression={compression!r}: only 'gzip'")
        self._writer.dataset(name, np.asarray(data), compression == "gzip")


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def guess_chunk(shape: Sequence[int], itemsize: int) -> Tuple[int, ...]:
    """h5py's chunk guess (``h5py/_hl/filters.py``): halve the axes in turn
    until the chunk is near a target that grows with the dataset's size
    (16 KiB to 1 MiB)."""
    base, lo, hi = 16 * 1024, 8 * 1024, 1024 * 1024
    shape = tuple(shape)
    ndims = len(shape)
    if ndims == 0:
        raise ValueError("chunks need a dataset of rank 1 or more")
    chunks = np.array([x if x != 0 else 1024 for x in shape], dtype="=f8")
    if not np.all(np.isfinite(chunks)):
        raise ValueError("illegal value in chunk tuple")
    dset_size = np.prod(chunks) * itemsize
    target = base * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    if target > hi:
        target = hi
    elif target < lo:
        target = lo
    idx = 0
    while True:
        chunk_bytes = np.prod(chunks) * itemsize
        if (chunk_bytes < target or abs(chunk_bytes - target) / target
                < 0.5) and chunk_bytes < hi:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % ndims] = np.ceil(chunks[idx % ndims] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


def _datatype_message(dtype: np.dtype) -> bytes:
    order = 1 if dtype.byteorder == ">" or (
        dtype.byteorder == "=" and np.little_endian is False) else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = order | (0x8 if dtype.kind == "i" else 0)
        head = bytes([0x10 | 0, bits, 0, 0]) + struct.pack("<I", size)
        return head + struct.pack("<HH", 0, 8 * size)
    if dtype.kind == "f" and size in (4, 8):
        sign, e_loc, e_size, m_size, bias = ((31, 23, 8, 23, 127) if size == 4
                                             else (63, 52, 11, 52, 1023))
        head = bytes([0x10 | 1, order | 0x20, sign, 0]) + struct.pack(
            "<I", size)
        return head + struct.pack("<HHBBBBI", 0, 8 * size, e_loc, e_size, 0,
                                  m_size, bias)
    raise HDF5Error(f"dtype {dtype} not supported (integers and float32/64 "
                    "are)")


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = data + b"\0" * (-len(data) % 8)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: Sequence[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


class _Node:
    """A group being written: its children by name (datasets as header
    addresses, groups as nodes)."""

    def __init__(self):
        self.children: Dict[str, object] = {}


class _Writer:
    """Appends datasets as they come; groups and the superblock on close."""

    def __init__(self, path: str):
        self.path = path
        self.f = open(path, "wb")
        self.f.write(b"\0" * 96)  # the superblock, written last
        self.root = _Node()

    def tell(self) -> int:
        return self.f.tell()

    def append(self, data: bytes) -> int:
        addr = self.f.tell()
        self.f.write(data)
        return addr

    def dataset(self, name: str, data: np.ndarray, gzip: bool) -> None:
        parts = [p for p in name.split("/") if p]
        if not parts:
            raise ValueError(f"dataset name {name!r}")
        node = self.root
        for part in parts[:-1]:
            node = node.children.setdefault(part, _Node())
            if not isinstance(node, _Node):
                raise ValueError(f"{name}: {part} is a dataset")
        if parts[-1] in node.children:
            raise ValueError(f"{name} already exists")
        space = struct.pack("<BBB5x", 1, data.ndim, 0) + b"".join(
            struct.pack("<Q", n) for n in data.shape)
        messages = [_message(MSG_DATASPACE, space),
                    _message(MSG_DATATYPE, _datatype_message(data.dtype), 1)]
        if not gzip:
            raw = np.ascontiguousarray(data).tobytes()
            addr = self.append(raw) if raw else UNDEF
            # allocation late, fill written if set, the default fill value
            messages += [
                _message(MSG_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0), 1),
                _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, addr,
                                                 len(raw)))]
        else:
            if data.ndim == 0:
                raise ValueError("a scalar dataset cannot be compressed")
            chunks = guess_chunk(data.shape, data.dtype.itemsize)
            btree = self._write_chunks(data, chunks) if data.size else UNDEF
            layout = struct.pack("<BBBQ", 3, 2, data.ndim + 1, btree)
            layout += struct.pack(f"<{data.ndim + 1}I", *chunks,
                                  data.dtype.itemsize)
            name_ = b"deflate\0"
            pipe = struct.pack("<BB6x", 1, 1) + struct.pack(
                "<HHHH", FILTER_DEFLATE, len(name_), 1, 1) + name_
            pipe += struct.pack("<II", GZIP_LEVEL, 0)  # one value, padded
            # allocation incremental, fill written if set, default fill
            messages += [
                _message(MSG_FILL, struct.pack("<BBBBI", 2, 3, 2, 1, 0), 1),
                _message(MSG_LAYOUT, layout), _message(MSG_FILTERS, pipe)]
        node.children[parts[-1]] = self.append(_object_header(messages))

    def _write_chunks(self, data, chunks) -> int:
        """Each chunk deflated, then the B-tree over them; the root node's
        address."""
        counts = [-(-n // c) for n, c in zip(data.shape, chunks)]
        entries = []  # (offset, size, address)
        for pos in itertools.product(*[range(n) for n in counts]):
            offset = tuple(p * c for p, c in zip(pos, chunks))
            block = np.zeros(chunks, data.dtype)  # edge chunks: fill value
            sel = tuple(slice(o, min(o + c, n))
                        for o, c, n in zip(offset, chunks, data.shape))
            block[tuple(slice(0, s.stop - s.start) for s in sel)] = data[sel]
            raw = zlib.compress(block.tobytes(), GZIP_LEVEL)
            entries.append((offset, len(raw), self.append(raw)))
        return self._chunk_btree(entries, chunks, data.ndim)

    def _chunk_btree(self, entries, chunks, ndim) -> int:
        """Version-1 B-tree nodes of type 1 (2K = 64 entries each), built
        bottom-up; each key is (size, mask, offset..., 0) and the last key
        of a node is the chunk after its last child."""
        def key(size, offset):
            return struct.pack("<II", size, 0) + struct.pack(
                f"<{ndim + 1}Q", *offset, 0)

        end = tuple(o + c for o, c in zip(entries[-1][0], chunks))
        level, nodes = 0, entries
        key_size = 8 + 8 * (ndim + 1)
        node_size = 24 + 2 * CHUNK_K * 8 + (2 * CHUNK_K + 1) * key_size
        while True:
            groups = [nodes[i:i + 2 * CHUNK_K]
                      for i in range(0, len(nodes), 2 * CHUNK_K)]
            parents = []
            for g_i, group in enumerate(groups):
                right = (groups[g_i + 1][0][0] if g_i + 1 < len(groups)
                         else end)
                body = b"".join(key(size, off) + struct.pack("<Q", addr)
                                for off, size, addr in group)
                body += key(0, right)
                head = b"TREE" + struct.pack("<BBHQQ", 1, level, len(group),
                                             UNDEF, UNDEF)
                raw = head + body
                raw += b"\0" * (node_size - len(raw))
                parents.append((group[0][0], 0, self.append(raw)))
            if len(parents) == 1:
                return parents[0][2]
            nodes, level = parents, level + 1

    def _write_group(self, node: _Node) -> Tuple[int, int, int]:
        """Children first, then the local heap, symbol-table nodes, B-tree
        and object header; returns (header, B-tree, heap) addresses."""
        links = {}
        for name, child in node.children.items():
            links[name] = (self._write_group(child) if isinstance(child, _Node)
                           else (child, None, None))
        names = sorted(links, key=lambda s: s.encode("utf-8"))
        heap_data = bytearray(b"\0" * 8)  # offset 0: the empty name
        offsets = {}
        for name in names:
            offsets[name] = len(heap_data)
            raw = name.encode("utf-8") + b"\0"
            heap_data += raw + b"\0" * (-len(raw) % 8)
        heap_data += b"\0" * 16  # room for a free block
        free = len(heap_data) - 16
        heap_data[free:free + 16] = struct.pack("<QQ", 1, 16)
        heap_data_addr = self.append(bytes(heap_data))
        heap = self.append(b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(heap_data), free, heap_data_addr))
        per_node = 2 * GROUP_LEAF_K
        snods = []
        for i in range(0, max(len(names), 1), per_node):
            chunk = names[i:i + per_node]
            body = b""
            for name in chunk:
                addr, bt, hp = links[name]
                if bt is None:
                    body += struct.pack("<QQI4x16x", offsets[name], addr, 0)
                else:
                    body += struct.pack("<QQI4xQQ", offsets[name], addr, 1,
                                        bt, hp)
            raw = b"SNOD" + struct.pack("<BxH", 1, len(chunk)) + body
            raw += b"\0" * (8 + per_node * 40 - len(raw))
            snods.append((chunk, self.append(raw)))
        if len(snods) > 2 * GROUP_NODE_K:
            raise HDF5Error(f"a group of {len(names)} members is more than "
                            "one B-tree node holds")
        body = struct.pack("<Q", 0)  # the first key: the empty name
        for chunk, addr in snods:
            last = offsets[chunk[-1]] if chunk else 0
            body += struct.pack("<QQ", addr, last)
        raw = b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), UNDEF, UNDEF)
        raw += body
        raw += b"\0" * (24 + 2 * GROUP_NODE_K * 8 + (2 * GROUP_NODE_K + 1) * 8
                        - len(raw))
        btree = self.append(raw)
        header = self.append(_object_header(
            [_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
        return header, btree, heap

    def close(self) -> None:
        try:
            header, btree, heap = self._write_group(self.root)
            eof = self.tell()
            sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
            sb += struct.pack("<HHI", GROUP_LEAF_K, GROUP_NODE_K, 0)
            sb += struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
            sb += struct.pack("<QQI4xQQ", 0, header, 1, btree, heap)
            self.f.seek(0)
            self.f.write(sb)
        finally:
            self.f.close()
