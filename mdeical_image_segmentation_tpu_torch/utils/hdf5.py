"""A small HDF5 codec on the standard library, numpy and ``zlib``.

The machine with the card has no h5py, and the volumetric pipeline reads
its volumes from HDF5 files and writes its predictions into one.  This
module covers the part of h5py's API that pipeline uses:

- ``File(path, "r" | "r+" | "w")`` as a context manager; ``f["a/b"]``,
  ``key in f`` and ``keys()`` in every mode;
- ``Dataset.shape``, ``.dtype``, ``.ndim``, ``.chunks``, ``.compression``,
  ``ds[:]`` and ``ds[index]`` with ints and slices, reading only the chunks
  the index touches;
- ``File.create_dataset(name, data=..., compression="gzip")`` in ``"w"``
  and ``"r+"``, making the groups on the path; and
  ``create_dataset(name, shape=..., dtype=..., chunks=True | (...),
  compression="gzip")``, a chunked dataset filled region by region with
  ``ds[index] = array`` (unit steps) without the whole array in memory.

What it reads is the file h5py writes by default: superblock version 0,
version-1 object headers, symbol-table groups (a version-1 B-tree of
symbol-table nodes plus a local heap) nested to any depth, contiguous,
compact and chunked layouts (a version-1 B-tree of any depth), the deflate
and shuffle filters, and little- or big-endian integers of 1-8 bytes and
IEEE floats of 4 and 8 bytes.  Anything else (a ``libver="latest"`` file,
another filter, a compound or string type, a soft link) raises and names
what it found.

What it writes: each dataset contiguous, or chunked (h5py's chunk guess
unless given) through deflate at level 4, h5py's default.  Everything new
goes to the end of the file.  A group that gains members (``"r+"`` appends
to a file h5py or the port wrote; ``"w"`` starts from an empty root group)
gets, when the file closes, its names appended to a copy of its local heap
at the end of the file and its symbol-table nodes written anew there, under
a B-tree whose root node is rewritten where it stands; the heap header
stays where it stands too, with its data address patched.  So the B-tree
and heap addresses that the group's object header, its parent's entry and
the superblock cache stay true, and only the superblock's end-of-file
address is patched.  Replaced structures are left as unreferenced space, as
the library leaves them.  A chunked dataset's chunk B-tree is written when
the file closes, and its address patched into its layout message.
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
HEAP_FREE_NULL = 1  # the end of a local heap's free list

# object header message types
MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x1, 0x2, 0x3
MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x5, 0x6, 0x7, 0x8
MSG_FILTERS = 0xB
MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x10, 0x11

FILTER_DEFLATE, FILTER_SHUFFLE = 1, 2
GROUP_LEAF_K, GROUP_NODE_K, CHUNK_K = 4, 16, 32  # the library's defaults
GZIP_LEVEL = 4
SUPERBLOCK_EOF = 40  # the end-of-file address in a version-0 superblock


class HDF5Error(ValueError):
    """A file this codec does not read, or a malformed one."""


class _Store:
    """An open file: little-endian fields at absolute addresses, and for a
    writable file, writes in place and appends at the end of the file."""

    def __init__(self, path: str, mode: str):
        self.path = path
        self.writable = mode != "r"
        flags = os.O_RDWR if self.writable else os.O_RDONLY
        if mode == "w":
            flags |= os.O_CREAT | os.O_TRUNC
        self.fd = os.open(path, flags, 0o666)
        self.eof = os.fstat(self.fd).st_size
        self.leaf_k, self.node_k = GROUP_LEAF_K, GROUP_NODE_K
        self.dirty: List[object] = []  # groups and datasets to flush

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

    def write(self, addr: int, data) -> None:
        view = memoryview(data).cast("B")
        while len(view):
            n = os.pwrite(self.fd, view, addr)
            view, addr = view[n:], addr + n

    def append(self, data) -> int:
        addr = self.eof
        self.write(addr, data)
        self.eof += memoryview(data).nbytes
        return addr

    def mark(self, obj) -> None:
        if not any(o is obj for o in self.dirty):
            self.dirty.append(obj)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


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

    def __init__(self, store: _Store, addr: int):
        head = store.read(addr, 16)
        version, _, n_msgs, _, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise HDF5Error(f"object header version {version} at {addr} not "
                            "supported (a libver='latest' file?)")
        self.messages: List[Tuple[int, int, bytes]] = []
        blocks = [(addr + 16, size)]
        while blocks and len(self.messages) < n_msgs:
            start, length = blocks.pop(0)
            block = store.read(start, length)
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
    """An HDF5 dataset; one made in a writable file with ``shape=`` (or
    from ``data=`` with gzip) also takes ``ds[index] = array``."""

    def __init__(self, store: _Store, header: _ObjectHeader, name: str):
        self._store, self.name = store, name
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
        # where a dataset made since the file was opened keeps its chunk
        # B-tree's address (patched when the file closes); None: read only
        self._btree_field: Optional[int] = None
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

    def __setitem__(self, index, value) -> None:
        """Write ``value`` (broadcast to the selection) into the chunks the
        index touches: each is encoded again and appended, one chunk in
        memory at a time."""
        if self._btree_field is None:
            raise HDF5Error(f"{self.name}: only chunked datasets made since "
                            "the writable file was opened are written")
        box, post = _normalize_index(index, self.shape)
        if any(isinstance(p, slice) and p.step not in (None, 1)
               for p in post):
            raise IndexError("writes take unit steps")
        sel = tuple(b - a for (a, b), p in zip(box, post)
                    if isinstance(p, slice))
        value = np.broadcast_to(np.asarray(value, dtype=self.dtype), sel)
        value = value.reshape(tuple(b - a for a, b in box))
        if value.size == 0:
            return
        index = self._chunk_index()
        ranges = [range(a // c, (b - 1) // c + 1)
                  for (a, b), c in zip(box, self.chunks)]
        for pos in itertools.product(*ranges):
            offset = tuple(p * c for p, c in zip(pos, self.chunks))
            src, dst, covered = [], [], True
            for (a, b), o, c, n in zip(box, offset, self.chunks, self.shape):
                lo, hi = max(a, o), min(b, o + c)
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - a, hi - a))
                covered &= lo == o and hi == min(o + c, n)
            entry = index.get(offset)
            if covered or entry is None:
                block = np.full(self.chunks, self._fill, self.dtype)
            else:
                block = self._decode_chunk(*entry).copy()
            block[tuple(src)] = value[tuple(dst)]
            raw = block.tobytes()
            if self.compression:
                raw = zlib.compress(raw, self.compression_opts)
            index[offset] = (self._store.append(raw), len(raw), 0)
        self._store.mark(self)

    def _flush(self) -> None:
        """Write the chunk B-tree and patch its address into the layout
        message."""
        index = self._chunk_index()
        if index:
            entries = [(off, size, addr)
                       for off, (addr, size, _) in sorted(index.items())]
            self._addr = _chunk_btree(self._store, entries, self.chunks)
            self._store.write(self._btree_field,
                              struct.pack("<Q", self._addr))

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
            mm = np.memmap(self._store.path, dtype=self.dtype, mode="r",
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
                for key, child in _btree_entries(self._store, self._addr, 1,
                                                 rank):
                    size, mask = struct.unpack_from("<II", key)
                    offset = struct.unpack_from(f"<{rank}Q", key, 8)[:-1]
                    index[offset] = (child, size, mask)
            self._index = index
        return self._index

    def _decode_chunk(self, addr: int, size: int, mask: int) -> np.ndarray:
        data = self._store.read(addr, size)
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


def _btree_entries(store: _Store, addr: int, node_type: int,
                   rank: int = 0) -> Iterator[Tuple[bytes, int]]:
    """(left key, child address) of every leaf entry of a version-1 B-tree,
    any depth."""
    key_size = 8 if node_type == 0 else 8 + 8 * rank
    head = store.read(addr, 24)
    if head[:4] != b"TREE":
        raise HDF5Error(f"no B-tree node at {addr}")
    ntype, level, used = head[4], head[5], struct.unpack_from("<H", head, 6)[0]
    if ntype != node_type:
        raise HDF5Error(f"B-tree node of type {ntype} at {addr}, want "
                        f"{node_type}")
    body = store.read(addr + 24, used * (key_size + 8) + key_size)
    for i in range(used):
        pos = i * (key_size + 8)
        key = body[pos:pos + key_size]
        child = struct.unpack_from("<Q", body, pos + key_size)[0]
        if level == 0:
            yield key, child
        else:
            yield from _btree_entries(store, child, node_type, rank)


class Group:
    """A symbol-table group.  Its members are ``_entries``: name → (heap
    offset of the name, the 32 bytes of its symbol-table entry after the
    name: object header address, cache type, scratch pad)."""

    def __init__(self, store: _Store, name: str, btree: int, heap: int,
                 new: bool = False):
        self._store, self.name = store, name
        self._btree, self._heap = btree, heap
        self._children: Dict[str, object] = {}
        if new:  # offset 0 holds the empty name
            self._heap_data, self._entries = bytearray(8), {}
        else:
            self._heap_data, self._entries = _read_symbol_table(
                store, btree, heap, name)

    @classmethod
    def _from_header(cls, store: _Store, header: _ObjectHeader, name: str):
        stab = header.find(MSG_SYMBOL_TABLE)
        if stab is None:
            kind = ("link messages (a libver='latest' group)"
                    if header.types() & {MSG_LINK, MSG_LINK_INFO}
                    else "no symbol table")
            raise HDF5Error(f"group {name}: {kind} not supported")
        return cls(store, name, *struct.unpack_from("<QQ", stab))

    def keys(self) -> List[str]:
        return list(self._entries)

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
            if not isinstance(node, Group) or part not in node._entries:
                raise KeyError(f"no object {path!r} in {self.name!r}")
            node = node._open(part)
        return node

    def _open(self, name: str):
        if name not in self._children:
            full = f"{self.name.rstrip('/')}/{name}"
            addr = struct.unpack_from("<Q", self._entries[name][1])[0]
            header = _ObjectHeader(self._store, addr)
            types = header.types()
            if MSG_SYMBOL_TABLE in types or MSG_LINK_INFO in types:
                child = Group._from_header(self._store, header, full)
            elif MSG_LAYOUT in types:
                child = Dataset(self._store, header, full)
            else:
                raise HDF5Error(f"{full}: object with messages "
                                f"{sorted(types)} is neither a group nor a "
                                "dataset")
            self._children[name] = child
        return self._children[name]

    # -- writing -------------------------------------------------------------

    def _link(self, name: str, header: int, scratch: Optional[bytes] = None
              ) -> None:
        """Add ``name`` → the object header at ``header``; ``scratch`` is a
        subgroup's cached (B-tree, heap) addresses."""
        offset = len(self._heap_data)
        raw = name.encode("utf-8") + b"\0"
        self._heap_data += raw + b"\0" * (-len(raw) % 8)
        tail = struct.pack("<QI4x", header, 0 if scratch is None else 1)
        self._entries[name] = (offset, tail + (scratch or b"\0" * 16))
        self._store.mark(self)

    def _flush(self) -> None:
        """The heap's data and the symbol-table nodes at the end of the
        file, the B-tree's root node and the heap header in place."""
        store = self._store
        head = store.read(self._heap, 32)
        # a heap read from the file keeps its free list (its blocks lie in
        # the data copied); a new group's has none
        free = (struct.unpack_from("<Q", head, 16)[0] if head[:4] == b"HEAP"
                else HEAP_FREE_NULL)
        data_addr = store.append(bytes(self._heap_data))
        store.write(self._heap, b"HEAP" + struct.pack(
            "<B3xQQQ", 0, len(self._heap_data), free, data_addr))
        per_node = 2 * store.leaf_k
        names = sorted(self._entries, key=lambda s: s.encode("utf-8"))
        children = []  # (left key, right key, address) of each node
        left = 0
        for i in range(0, len(names), per_node):
            chunk = names[i:i + per_node]
            body = b"".join(struct.pack("<Q", self._entries[n][0])
                            + self._entries[n][1] for n in chunk)
            raw = b"SNOD" + struct.pack("<BxH", 1, len(chunk)) + body
            raw += b"\0" * (8 + per_node * 40 - len(raw))
            right = self._entries[chunk[-1]][0]
            children.append((left, right, store.append(raw)))
            left = right
        _group_btree(store, self._btree, children)


def _read_symbol_table(store: _Store, btree: int, heap: int, name: str):
    head = store.read(heap, 32)
    if head[:4] != b"HEAP":
        raise HDF5Error(f"group {name}: no local heap at {heap}")
    heap_size, _, heap_data = struct.unpack_from("<QQQ", head, 8)
    names = store.read(heap_data, heap_size)
    entries: Dict[str, Tuple[int, bytes]] = {}
    for _, snod in _btree_entries(store, btree, 0):
        node = store.read(snod, 8)
        if node[:4] != b"SNOD":
            raise HDF5Error(f"group {name}: no symbol table node at {snod}")
        count = struct.unpack_from("<H", node, 6)[0]
        raw = store.read(snod + 8, 40 * count)
        for i in range(count):
            name_off, _, cache = struct.unpack_from("<QQI", raw, 40 * i)
            if cache == 2:
                raise HDF5Error(f"group {name}: soft links not supported")
            end = names.index(b"\0", name_off)
            entries[names[name_off:end].decode("utf-8")] = (
                name_off, raw[40 * i + 8:40 * i + 40])
    data = bytearray(names)
    data += b"\0" * (-len(data) % 8)
    return data, entries


class File(Group):
    """An HDF5 file: ``"r"`` to read, ``"r+"`` to read and add datasets,
    ``"w"`` to create (truncating)."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "r+", "w"):
            raise ValueError(f"mode {mode!r}: 'r', 'r+' or 'w'")
        self.path, self.mode = os.fspath(path), mode
        store = _Store(self.path, mode)
        try:
            if mode == "w":
                header, btree, heap = _new_group(store, reserve=96)
                super().__init__(store, "/", btree, heap, new=True)
                store.mark(self)
                self._write_superblock(header)
            else:
                header = self._read_superblock(store)
                super().__init__(store, "/", *self._root_tables(store,
                                                                header))
        except BaseException:
            store.close()
            raise

    def _read_superblock(self, store: _Store) -> int:
        sb = store.read(0, 96)
        if sb[:8] != SIGNATURE:
            raise HDF5Error(f"{self.path}: not an HDF5 file (no signature "
                            "at offset 0)")
        if sb[8] != 0:
            raise HDF5Error(f"{self.path}: superblock version {sb[8]} not "
                            "supported (version 0 is; libver='latest' files "
                            "are not)")
        if sb[13] != 8 or sb[14] != 8:
            raise HDF5Error(f"{self.path}: offsets of {sb[13]} and lengths "
                            f"of {sb[14]} bytes not supported")
        base, _, eof = struct.unpack_from("<QQQ", sb, 24)
        if base != 0:
            raise HDF5Error(f"{self.path}: base address {base} not "
                            "supported")
        store.leaf_k, store.node_k = struct.unpack_from("<HH", sb, 16)
        store.eof = max(store.eof, eof)
        return struct.unpack_from("<Q", sb, 56 + 8)[0]

    def _root_tables(self, store: _Store, header: int) -> Tuple[int, int]:
        stab = _ObjectHeader(store, header).find(MSG_SYMBOL_TABLE)
        if stab is None:
            raise HDF5Error(f"{self.path}: the root group has no symbol "
                            "table (a libver='latest' file?)")
        return struct.unpack_from("<QQ", stab)

    def _write_superblock(self, root: int) -> None:
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        sb += struct.pack("<HHI", GROUP_LEAF_K, GROUP_NODE_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, self._store.eof, UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, root, 1, self._btree, self._heap)
        self._store.write(0, sb)

    def close(self) -> None:
        """Write what was added since the file was opened (chunk B-trees,
        groups, the end-of-file address) and close the file."""
        store = self._store
        if store.fd is None:
            return
        try:
            for obj in store.dirty:
                if isinstance(obj, Dataset):
                    obj._flush()
            for obj in store.dirty:
                if isinstance(obj, Group):
                    obj._flush()
            if store.dirty:
                store.write(SUPERBLOCK_EOF, struct.pack("<Q", store.eof))
            store.dirty = []
        finally:
            store.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def create_dataset(self, name: str, data=None, *, shape=None, dtype=None,
                       chunks=None, compression: Optional[str] = None
                       ) -> Dataset:
        """A new dataset under ``name``, making the groups on its path.
        From ``data``: contiguous, or with ``compression="gzip"`` chunked
        (h5py's chunk guess) through deflate at level 4.  From ``shape``
        and ``dtype``: chunked (``chunks=True`` or None: h5py's guess, or a
        tuple), gzip or not, every chunk the fill value (0) until
        ``ds[index] = array`` writes it."""
        if not self._store.writable:
            raise ValueError(f"{self.path} is not open for writing")
        if compression not in (None, "gzip"):
            raise ValueError(f"compression={compression!r}: only 'gzip'")
        if data is not None:
            data = np.asarray(data)
            if shape is not None and tuple(shape) != data.shape:
                raise ValueError(f"shape {shape} and data {data.shape}")
            if dtype is not None:
                data = data.astype(dtype, copy=False)
            shape, dtype = data.shape, data.dtype
        elif shape is None or dtype is None:
            raise ValueError("create_dataset needs data, or a shape and a "
                             "dtype")
        elif compression is None and chunks is None:
            raise ValueError("a dataset made from a shape is chunked: give "
                             "chunks= or compression='gzip'")
        shape, dtype = tuple(int(n) for n in shape), np.dtype(dtype)
        _datatype_message(dtype)  # raises for a type the codec cannot write
        contiguous = compression is None and chunks is None
        if not contiguous:
            if not shape:
                raise ValueError("a scalar dataset cannot be chunked")
            if chunks in (None, True):
                chunks = guess_chunk(shape, dtype.itemsize)
            chunks = tuple(int(c) for c in chunks)
            if len(chunks) != len(shape) or min(chunks) < 1:
                raise ValueError(f"chunks {chunks} for shape {shape}")
        group, leaf = self._parent(name)
        messages = _shape_messages(shape, dtype)
        if contiguous:
            raw = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
            addr = self._store.append(raw) if raw.size else UNDEF
            # allocation late, fill written if set, the default fill value
            messages += [
                _message(MSG_FILL, struct.pack("<BBBBI", 2, 2, 2, 1, 0), 1),
                _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, addr,
                                                 raw.nbytes))]
            return self._add(group, leaf, messages)[0]
        layout = struct.pack("<BBBQ", 3, 2, len(shape) + 1, UNDEF)
        layout += struct.pack(f"<{len(shape) + 1}I", *chunks, dtype.itemsize)
        # allocation incremental, fill written if set, default fill
        messages += [
            _message(MSG_FILL, struct.pack("<BBBBI", 2, 3, 2, 1, 0), 1),
            _message(MSG_LAYOUT, layout)]
        if compression:
            deflate = b"deflate\0"
            pipe = struct.pack("<BB6x", 1, 1) + struct.pack(
                "<HHHH", FILTER_DEFLATE, len(deflate), 1, 1) + deflate
            pipe += struct.pack("<II", GZIP_LEVEL, 0)  # one value, padded
            messages.append(_message(MSG_FILTERS, pipe))
        ds, header = self._add(group, leaf, messages)
        # the layout message's data follows the 16-byte prefix and the
        # messages before it, each with an 8-byte message header
        ds._btree_field = header + 16 + sum(map(len, messages[:3])) + 8 + 3
        ds._index = {}
        if data is not None:
            ds[...] = data
        return ds

    def _parent(self, name: str) -> Tuple[Group, str]:
        """The group ``name`` goes into (groups on the path made as
        needed) and its last part, checked to be new."""
        parts = [p for p in name.split("/") if p]
        if not parts:
            raise ValueError(f"dataset name {name!r}")
        group: Group = self
        for part in parts[:-1]:
            if part not in group._entries:
                header, btree, heap = _new_group(self._store)
                group._link(part, header, struct.pack("<QQ", btree, heap))
                group._children[part] = Group(
                    self._store, f"{group.name.rstrip('/')}/{part}", btree,
                    heap, new=True)
                self._store.mark(group._children[part])
            group = group._open(part)
            if not isinstance(group, Group):
                raise ValueError(f"{name}: {part} is a dataset")
        if parts[-1] in group._entries:
            raise ValueError(f"{name} already exists")
        return group, parts[-1]

    def _add(self, group: Group, leaf: str, messages: List[bytes]
             ) -> Tuple[Dataset, int]:
        """The object header at the end of the file, linked in ``group``;
        the open dataset and its header's address."""
        header = self._store.append(_object_header(messages))
        group._link(leaf, header)
        return group._open(leaf), header


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


def _shape_messages(shape: Sequence[int], dtype: np.dtype) -> List[bytes]:
    space = struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", n) for n in shape)
    return [_message(MSG_DATASPACE, space),
            _message(MSG_DATATYPE, _datatype_message(dtype), 1)]


def _object_header(messages: Sequence[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _new_group(store: _Store, reserve: int = 0) -> Tuple[int, int, int]:
    """Room for an empty group's heap header and B-tree root node (filled
    when the file closes) and its object header; ``reserve`` zero bytes go
    first (a new file's superblock).  Returns (header, B-tree, heap)."""
    if reserve:
        store.append(b"\0" * reserve)
    heap = store.append(b"\0" * 32)
    btree = store.append(b"\0" * _group_node_size(store))
    header = store.append(_object_header(
        [_message(MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap))]))
    return header, btree, heap


def _group_node_size(store: _Store) -> int:
    k2 = 2 * store.node_k
    return 24 + k2 * 8 + (k2 + 1) * 8


def _group_btree(store: _Store, root: int,
                 children: List[Tuple[int, int, int]]) -> None:
    """A group's B-tree over its symbol-table nodes ``children`` ((left
    key, right key, address); keys are heap offsets of names), 2K children
    a node, the root node written at ``root``, the others appended."""
    per_node, level = 2 * store.node_k, 0
    size = _group_node_size(store)
    while True:
        groups = [children[i:i + per_node]
                  for i in range(0, len(children), per_node)] or [[]]
        if len(groups) == 1:
            addrs = [root]
        else:
            addrs = [store.append(b"\0" * size) for _ in groups]
        parents = []
        for i, (group, addr) in enumerate(zip(groups, addrs)):
            sibling = [addrs[i - 1] if i else UNDEF,
                       addrs[i + 1] if i + 1 < len(addrs) else UNDEF]
            body = struct.pack("<Q", group[0][0] if group else 0)
            for _, right, child in group:
                body += struct.pack("<QQ", child, right)
            raw = b"TREE" + struct.pack("<BBHQQ", 0, level, len(group),
                                        *sibling) + body
            store.write(addr, raw + b"\0" * (size - len(raw)))
            if group:
                parents.append((group[0][0], group[-1][1], addr))
        if len(groups) == 1:
            return
        children, level = parents, level + 1


def _chunk_btree(store: _Store, entries, chunks) -> int:
    """Version-1 B-tree nodes of type 1 (2K = 64 entries each) over the
    chunks ``entries`` ((offset, size, address), in offset order), built
    bottom-up; each key is (size, mask, offset..., 0) and the last key of a
    node is the chunk after its last child.  Returns the root's address."""
    ndim = len(chunks)

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
            parents.append((group[0][0], 0, store.append(raw)))
        if len(parents) == 1:
            return parents[0][2]
        nodes, level = parents, level + 1
