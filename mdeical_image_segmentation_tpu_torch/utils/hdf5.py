"""A small HDF5 codec on the standard library, numpy, ``zlib`` and small C
decoders (LZF, szip, n-bit).

The machine with the card has no h5py, and the volumetric pipeline reads
its volumes from HDF5 files and writes its predictions into one.  This
module covers the part of h5py's API that pipeline uses:

- ``File(path, "r" | "r+" | "w")`` as a context manager; ``f["a/b"]``,
  ``key in f`` (a dangling link is in its group, as h5py answers) and
  ``keys()`` in every mode;
- ``Dataset.shape``, ``.dtype``, ``.ndim``, ``.chunks``, ``.compression``,
  ``ds[:]`` and ``ds[index]`` with ints and slices, reading only the chunks
  the index touches;
- ``File.create_dataset(name, data=..., compression="gzip")`` in ``"w"``
  and ``"r+"``, making the groups on the path; and
  ``create_dataset(name, shape=..., dtype=..., chunks=True | (...),
  compression="gzip")``, a chunked dataset filled region by region with
  ``ds[index] = array`` (unit steps) without the whole array in memory.

What it reads is every file h5py writes for the pipeline, under any
``libver``:

- superblocks 0 and 1 (h5py's default) and 2 and 3 (``libver="v108"`` and
  newer), each version-2 structure's Jenkins lookup3 checksum verified;
  a superblock extension's B-tree K values (its other messages change
  nothing a reader needs);
- version-1 and version-2 (``OHDR`` / ``OCHK``) object headers;
- groups of three kinds: symbol tables (a version-1 B-tree of symbol-table
  nodes plus a local heap), compact link storage (Link messages in the
  header) and dense link storage (a fractal heap of Link messages under a
  version-2 B-tree name index; with ``track_order`` the creation-order
  index gives ``keys()`` h5py's order); hard, soft and external links
  (16 at most on a path, the library's limit), an external link's file
  found as the library finds it (``HDF5_EXT_PREFIX``, then the linking
  file's directory, then the working directory), opened read only at its
  first use and closed with the file; a missing one raises ``KeyError``;
- contiguous, compact and chunked layouts (layout messages 3 and 4), the
  chunks found through a version-1 B-tree of any depth or, in layout 4,
  the single-chunk, implicit, fixed-array (paged or not),
  extensible-array and version-2 B-tree indexes; unallocated chunks read
  as the fill value;
- external raw storage (a contiguous dataset's bytes in segments of other
  files, found under ``HDF5_EXTFILE_PREFIX`` or from the working
  directory, as the library finds them);
- virtual datasets: each mapping's "all" or regular hyperslab selections
  (every encoding HDF5 1.14 writes), later mappings over earlier ones,
  sources in the same file (".") or found as external links' files are
  (``HDF5_VDS_PREFIX``), a source that does not open read as the fill
  value; a region read reads only what the region maps;
- the deflate, shuffle, Fletcher-32 (verified, then stripped), szip
  (``csrc/szip_decompress.c``), n-bit (``csrc/nbit_decompress.c``), LZF
  (``csrc/lzf_decompress.c``) and scale-offset (integer and D-scale float)
  filters, each chunk's filter mask honoured;
- little- or big-endian integers of 1-8 bytes (a precision or bit offset
  that leaves bits unused read as HDF5's conversion reads them), IEEE
  floats of 2, 4 and 8 bytes, other float layouts of up to 8 bytes (read
  as the numpy float h5py picks), committed datatypes, and enums: h5py's
  bool (an int8 enum FALSE = 0, TRUE = 1) reads as ``bool``, any other
  integer enum as its base type.

Anything else raises ``HDF5Error`` and names what it found and the ROADMAP
item that holds it: compound, string, reference, variable-length, opaque,
bitfield, time and array types, messages kept in the shared-message index,
huge and filtered fractal-heap objects, unlimited and printf-named virtual
dataset mappings, n-bit over compound and array types, an append into a
group with more than one hard link, and a structure whose checksum does
not match.

What it writes: each dataset contiguous, or chunked (h5py's chunk guess
unless given) through deflate at level 4, h5py's default, under a
version-1 object header, layout message 3 and a version-1 chunk B-tree,
which the library reads in a file of any superblock version.  Everything
new goes to the end of the file.  A new file has superblock 0.  A group
that gains members in ``"r+"`` (or ``"w"``, which starts from an empty
root group):

- a symbol-table group gets, when the file closes, its names appended to a
  copy of its local heap at the end of the file and its symbol-table
  nodes written anew there, under a B-tree whose root node is rewritten
  where it stands; the heap header stays where it stands too, with its
  data address patched.  So the B-tree and heap addresses that the
  group's object header, its parent's entry and the superblock cache stay
  true.
- a link-message group gets its object header written anew at the end of
  the file as a version-2 header (fresh checksum) holding every link as a
  Link message (a dense group is so rewritten in compact form; the
  library converts it back to dense at its next insertion), and the one
  address that points at the header is patched: the superblock's root
  address (version 2 and 3: checksum recomputed, consistency flags left
  at 0), the version-0/1 superblock's root entry, or the parent group's
  link, itself rewritten the same way.  External and user-defined links
  keep the bytes of their values.

Only the superblock's end-of-file address is patched besides.  Replaced
structures are left as unreferenced space, as the library leaves them.  A
chunked dataset's chunk B-tree is written when the file closes, and its
address patched into its layout message.
"""

from __future__ import annotations

import ctypes
import itertools
import os
import struct
import weakref
import zlib
from typing import (Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np

from . import szip

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
HEAP_FREE_NULL = 1  # the end of a local heap's free list
HDF5_ITEM = "ROADMAP.md queue 1, item 20"

# object header message types
MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL, MSG_LINK, MSG_EXTERNAL, MSG_LAYOUT = 0x5, 0x6, 0x7, 0x8
MSG_FILTERS = 0xB
MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x10, 0x11
MSG_BTREE_K, MSG_REFCOUNT = 0x13, 0x16

FILTER_DEFLATE, FILTER_SHUFFLE, FILTER_FLETCHER32 = 1, 2, 3
FILTER_SZIP, FILTER_NBIT, FILTER_SCALEOFFSET, FILTER_LZF = 4, 5, 6, 32000
FILTERS = {FILTER_DEFLATE: "deflate", FILTER_SHUFFLE: "shuffle",
           FILTER_FLETCHER32: "fletcher32", FILTER_SZIP: "szip",
           FILTER_NBIT: "n-bit", FILTER_SCALEOFFSET: "scale-offset",
           FILTER_LZF: "lzf"}
NBIT_ATOMIC, NBIT_ORDER_BE = 1, 1  # the n-bit filter's client values
COMPRESSION = {FILTER_DEFLATE: "gzip", FILTER_SZIP: "szip",
               FILTER_LZF: "lzf"}  # h5py's names, in its order of lookup
GROUP_LEAF_K, GROUP_NODE_K, CHUNK_K = 4, 16, 32  # the library's defaults
GZIP_LEVEL = 4

# layout 4's chunk indexes
IDX_SINGLE, IDX_IMPLICIT, IDX_FARRAY, IDX_EARRAY, IDX_BT2 = 1, 2, 3, 4, 5


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
        self.base = 0  # where the superblock sits: after a user block
        self.leaf_k, self.node_k = GROUP_LEAF_K, GROUP_NODE_K
        self.chunk_k = CHUNK_K
        self.sb_version = 0
        self.root = None  # a weak reference to the File, where absolute
        # soft links start
        self.dirty: List[object] = []  # groups and datasets to flush
        # where relative names of other files start (the library's
        # "extpath"), and the files opened through external links and
        # virtual datasets' sources, read only, by absolute path
        self.dir = os.path.dirname(os.path.abspath(path))
        self.opened: Dict[str, "File"] = {}

    def close(self) -> None:
        opened, self.opened = self.opened, {}
        for f in opened.values():
            f.close()
        if self.fd is not None:
            os.close(self.fd)
            self.fd = None

    def _prefixed(self, prefix: str, name: str) -> str:
        """``name`` under ``prefix``, a leading "${ORIGIN}" the directory
        of this file."""
        if prefix.startswith("${ORIGIN}"):
            prefix = self.dir + prefix[len("${ORIGIN}"):]
        return os.path.join(prefix, name)

    def open_file(self, name: str, env: str) -> Optional["File"]:
        """The file an external link (``env`` "HDF5_EXT_PREFIX") or a
        virtual dataset's mapping ("HDF5_VDS_PREFIX") names, opened read only
        at its first use, or None where none opens.  The library's order
        (``H5F_prefix_open_file``): an absolute name as it is (then its last
        component in its place), each prefix of ``env`` (":"-separated),
        the directory of this file, then the working directory."""
        paths = []
        if os.path.isabs(name):
            paths.append(name)
            name = os.path.basename(name)
        paths += [self._prefixed(p, name)
                  for p in os.environ.get(env, "").split(":") if p]
        paths += [os.path.join(self.dir, name), name]
        for path in paths:
            key = os.path.abspath(path)
            if key in self.opened:
                return self.opened[key]
            if not os.path.isfile(path):
                continue
            try:
                self.opened[key] = File(path, "r")
            except (OSError, HDF5Error):
                continue
            return self.opened[key]
        return None

    def extfile_path(self, name: str) -> str:
        """Where an external raw data file lies: under
        ``HDF5_EXTFILE_PREFIX`` where that is set, else ``name`` as it is,
        relative to the working directory (``H5D__build_file_prefix``);
        raises ``FileNotFoundError`` where there is no such file."""
        prefix = os.environ.get("HDF5_EXTFILE_PREFIX", "")
        path = (self._prefixed(prefix, name) if prefix not in ("", ".")
                else name)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{self.path}: unable to open external "
                                    f"raw data file {path!r}")
        return path

    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self.fd, n, addr + self.base)
        if len(data) != n:
            raise HDF5Error(f"{self.path}: {n} bytes at {addr} run past the "
                            "end of the file")
        return data

    def checked(self, addr: int, n: int, signature: bytes) -> bytes:
        """``n`` bytes at ``addr`` that start with ``signature`` and end with
        the lookup3 checksum of the rest."""
        data = self.read(addr, n)
        if data[:len(signature)] != signature:
            raise HDF5Error(f"{self.path}: no {signature.decode()} structure "
                            f"at {addr}")
        _verify(data, f"{signature.decode()} at {addr}")
        return data

    def write(self, addr: int, data) -> None:
        view = memoryview(data).cast("B")
        while len(view):
            n = os.pwrite(self.fd, view, addr + self.base)
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
# checksums
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_MIX = (4, 6, 8, 16, 19, 4)  # lookup3's rotations
_FINAL = (14, 11, 25, 16, 4, 14, 24)


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, the checksum of every version-2
    structure of the format (``H5_checksum_lookup3``)."""
    length = len(data)
    v = [(0xDEADBEEF + length + initval) & _M32] * 3  # a, b, c
    blocks = (length - 1) // 12 if length else 0  # all but the last 1-12
    words = struct.unpack_from(f"<{3 * blocks}I", data)
    for i in range(0, len(words), 3):
        v = [(x + w) & _M32 for x, w in zip(v, words[i:i + 3])]
        # mix: x -= z; x ^= rot(z, k); z += y, the roles turning a, b, c
        for step, k in enumerate(_MIX):
            x, y, z = step % 3, (step + 1) % 3, (step + 2) % 3
            v[x] = ((v[x] - v[z]) & _M32) ^ _rot(v[z], k)
            v[z] = (v[z] + v[y]) & _M32
    if not length:
        return v[2]
    tail = struct.unpack_from("<III", data[4 * len(words):] + b"\0" * 12)
    v = [(x + w) & _M32 for x, w in zip(v, tail)]
    # final: x ^= y; x -= rot(y, k), x running c, a, b, c, ...
    for step, k in enumerate(_FINAL):
        x, y = (step + 2) % 3, (step + 1) % 3
        v[x] = ((v[x] ^ v[y]) - _rot(v[y], k)) & _M32
    return v[2]


def _verify(block: bytes, what: str) -> None:
    """The last 4 bytes of ``block`` are the lookup3 checksum of the rest;
    a mismatch raises, as the library does."""
    stored = struct.unpack_from("<I", block, len(block) - 4)[0]
    if lookup3(block[:-4]) != stored:
        raise HDF5Error(f"bad checksum in {what} (the file is corrupt)")


def fletcher32(data: bytes) -> int:
    """``H5_checksum_fletcher32``: big-endian 16-bit words, both sums folded
    every 360 words (and an odd last byte as a high byte), then folded to
    16 bits."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", count=n).astype(np.int64)
    s1 = s2 = 0
    for start in range(0, n, 360):
        block = words[start:start + 360]
        t = len(block)
        # s2 gains s1 t times plus each word once for every step from its
        # own to the block's end
        s2 += t * s1 + int(np.dot(block, np.arange(t, 0, -1)))
        s1 += int(block.sum())
        s1, s2 = s1 & _M32, s2 & _M32
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return ((s2 << 16) | s1) & _M32


# ---------------------------------------------------------------------------
# message parsers
# ---------------------------------------------------------------------------


def _uint(b: bytes, pos: int, n: int) -> int:
    return int.from_bytes(b[pos:pos + n], "little")


def _log2(n: int) -> int:
    """``H5VM_log2_gen``: floor(log2(n)), 0 for 0."""
    return max(n.bit_length() - 1, 0)


def _enc_size(n: int) -> int:
    """``H5VM_limit_enc_size``: bytes that hold any count up to n."""
    return _log2(n) // 8 + 1


IEEE = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
        8: (63, 52, 11, 0, 52, 1023)}


# numpy's float types as h5py picks among them for a file's float type:
# (itemsize, mantissa bits, largest and smallest exponent)
NUMPY_FLOATS = ((2, 10, 16, -14), (4, 23, 128, -126), (8, 52, 1024, -1022))

Convert = Optional[Callable[[np.ndarray], np.ndarray]]


def _parse_datatype(b: bytes) -> Tuple[np.dtype, np.dtype, Convert]:
    """(the stored dtype, the dtype h5py gives, the conversion from one to
    the other or None where it is a cast).  They differ for h5py's bool (an
    int8 enum read as ``bool``), for an integer whose precision or bit
    offset leaves bits unused (read as HDF5's conversion reads them: the
    value's bits shifted down, sign-extended where signed) and for a float
    whose fields are not IEEE half, single or double (read as the numpy
    float h5py picks: the smallest at least as wide that holds its mantissa
    and exponent range)."""
    cls, version = b[0] & 0x0F, b[0] >> 4
    bits = b[1] | (b[2] << 8) | (b[3] << 16)
    size = struct.unpack_from("<I", b, 4)[0]
    order = ">" if bits & 1 else "<"
    if version not in (1, 2, 3, 4):
        raise HDF5Error(f"datatype message version {version} not supported")
    if cls == 0:  # fixed-point
        if size not in (1, 2, 4, 8):
            raise HDF5Error(f"integer of {size} bytes not supported")
        signed = bool(bits & 0x8)
        dt = np.dtype(f"{order}{'i' if signed else 'u'}{size}")
        offset, precision = struct.unpack_from("<HH", b, 8)
        if (offset, precision) == (0, 8 * size):
            return dt, dt, None
        if not 0 < precision <= 8 * size - offset:
            raise HDF5Error(f"integer of {size} bytes with precision "
                            f"{precision} at bit {offset}")
        return dt, dt, lambda a: _int_bits(a, offset, precision, signed, dt)
    if cls == 1:  # floating point
        if bits & 0x40:
            raise HDF5Error("VAX-order floats not supported")
        offset, precision, e_loc, e_size, m_loc, m_size, bias = struct.unpack_from(
            "<HHBBBBI", b, 8)
        sign = (bits >> 8) & 0xFF
        fields = (sign, e_loc, e_size, m_loc, m_size, bias)
        if (size in IEEE and offset == 0 and precision == 8 * size
                and fields == IEEE[size]):
            dt = np.dtype(f"{order}f{size}")
            return dt, dt, None
        if (bits >> 4) & 3 != 2 or not 1 <= size <= 8 or max(
                sign, e_loc + e_size - 1, m_loc + m_size - 1) >= 8 * size:
            raise HDF5Error(f"float of {size} bytes with layout {fields} and "
                            f"normalization {(bits >> 4) & 3} not supported "
                            f"({HDF5_ITEM})")
        for width, nmant, maxexp, minexp in NUMPY_FLOATS:
            if (width >= size and m_size <= nmant
                    and 2 ** e_size - bias - 1 <= maxexp
                    and 1 - bias >= minexp):
                break
        else:
            raise HDF5Error(f"float of {size} bytes with layout {fields}: "
                            "wider than float64 (h5py reads it as long "
                            f"double; {HDF5_ITEM})")
        dt = np.dtype(f"{order}f{width}")
        stored = np.dtype(f"{order}u{size}" if size in (1, 2, 4, 8)
                          else f"V{size}")
        return stored, dt, lambda a: _float_bits(a, order, fields, dt)
    if cls == 8:  # enumeration: h5py gives the base type, bool for its own
        base, _, convert = _parse_datatype(b[8:])
        if base.kind not in "iu":
            raise HDF5Error(f"enum over {base} not supported")
        n, pos, names = bits & 0xFFFF, 8 + 12, []
        for _ in range(n):
            end = b.index(b"\0", pos)
            names.append(b[pos:end])
            # versions 1 and 2 pad each name (with its NUL) to 8 bytes, 3
            # and 4 do not
            pos += (end + 1 - pos) + (-(end + 1 - pos) % 8 if version < 3
                                      else 0)
        values = np.frombuffer(b, base, count=n, offset=pos).tolist()
        if dict(zip(names, values)) == {b"FALSE": 0, b"TRUE": 1}:
            return base, np.dtype(bool), convert
        return base, base, convert
    names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
             6: "compound", 7: "reference", 9: "variable-length",
             10: "array"}
    raise HDF5Error(f"datatype class {names.get(cls, cls)} not supported "
                    f"({HDF5_ITEM})")


def _uint64(a: np.ndarray, order: str) -> np.ndarray:
    """Each element's bytes (in byte order ``order``) as an unsigned
    integer."""
    size = a.dtype.itemsize
    raw = np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8)
    raw = raw.reshape(-1, size).astype(np.uint64)
    if order == "<":
        raw = raw[:, ::-1]
    out = np.zeros(len(raw), np.uint64)
    for j in range(size):
        out = (out << np.uint64(8)) | raw[:, j]
    return out.reshape(a.shape)


def _int_bits(a: np.ndarray, offset: int, precision: int, signed: bool,
              dt: np.dtype) -> np.ndarray:
    """HDF5's integer conversion from a type of ``precision`` bits at bit
    ``offset`` to the full-width type ``dt``: the bits shifted down, then
    sign-extended where signed."""
    width = 8 * dt.itemsize
    u = np.ascontiguousarray(a, dt.newbyteorder("=")).view(f"u{dt.itemsize}")
    v = u << u.dtype.type(width - precision - offset)  # to the top bit
    if signed:
        v = v.view(f"i{dt.itemsize}")
    return (v >> v.dtype.type(width - precision)).astype(dt)


def _float_bits(a: np.ndarray, order: str, fields: Tuple[int, ...],
                dt: np.dtype) -> np.ndarray:
    """HDF5's float conversion from a type of sign bit, exponent and
    mantissa ``fields`` (implied leading one) to the numpy float ``dt``,
    which holds every value of the source exactly."""
    sign, e_loc, e_size, m_loc, m_size, bias = fields
    u = _uint64(a, order)
    e = ((u >> np.uint64(e_loc)) & np.uint64((1 << e_size) - 1)).astype(
        np.int64)
    m = ((u >> np.uint64(m_loc)) & np.uint64((1 << m_size) - 1)).astype(
        np.float64)
    with np.errstate(over="ignore"):
        value = np.where(
            e == 0, np.ldexp(m, np.full(e.shape, 1 - bias - m_size, np.int32)),
            np.ldexp(1.0 + m / 2.0 ** m_size, (e - bias).astype(np.int32)))
    value = np.where(e == (1 << e_size) - 1,
                     np.where(m == 0, np.inf, np.nan), value)
    value = np.where((u >> np.uint64(sign)) & np.uint64(1), -value, value)
    return value.astype(dt)


def _parse_dataspace(b: bytes) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(shape, maximum shape; UNDEF for an unlimited axis)."""
    version, rank, flags = b[0], b[1], b[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if b[3] == 2:
            raise HDF5Error("null dataspace (an empty dataset) not supported")
        pos = 4
    else:
        raise HDF5Error(f"dataspace message version {version} not supported")
    shape = struct.unpack_from(f"<{rank}Q", b, pos)
    maxshape = (struct.unpack_from(f"<{rank}Q", b, pos + 8 * rank)
                if flags & 1 else shape)
    return shape, maxshape


def _parse_filters(b: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
    """(filter id, client values) in pipeline order; version 1 pads names
    and odd value counts to 8 bytes, version 2 has names only for ids of
    256 and up, unpadded."""
    version, n = b[0], b[1]
    if version not in (1, 2):
        raise HDF5Error(f"filter pipeline message version {version} not "
                        "supported")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(n):
        fid = struct.unpack_from("<H", b, pos)[0]
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", b, pos + 2)[0]
            pos += 4
        else:
            name_len = 0
            pos += 2
        _flags, n_vals = struct.unpack_from("<HH", b, pos)
        pos += 4
        name = b[pos:pos + name_len].split(b"\0")[0].decode("latin-1")
        pos += name_len
        vals = struct.unpack_from(f"<{n_vals}I", b, pos)
        pos += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
        if fid not in FILTERS:
            raise HDF5Error(f"filter {fid} ({name or 'unnamed'}) not "
                            "supported (deflate, shuffle, fletcher32, szip, "
                            f"n-bit, scale-offset and lzf are; {HDF5_ITEM})")
        if fid == FILTER_NBIT and len(vals) > 3 and not vals[1] and (
                vals[3] != NBIT_ATOMIC):
            kind = "an array" if vals[3] == 2 else "a compound"
            raise HDF5Error(f"n-bit over {kind} datatype not supported "
                            f"({HDF5_ITEM})")
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
    """The messages of a version-1 or version-2 object header,
    continuations followed; NIL messages and gaps skipped.  ``messages``
    holds (type, flags, data); ``order`` each one's creation order (version
    2 headers that track it, else None)."""

    def __init__(self, store: _Store, addr: int):
        self.addr = addr
        self.messages: List[Tuple[int, int, bytes]] = []
        self.order: List[Optional[int]] = []
        if store.read(addr, 4) == b"OHDR":
            self._read_v2(store, addr)
        else:
            self._read_v1(store, addr)
        self._store = store
        for mtype, mflags, data in self.messages:
            if mflags & 0x2 and (mtype != MSG_DATATYPE
                                 or _shared_address(data) is None):
                raise HDF5Error(f"shared message of type {mtype} kept in the "
                                "file's shared-message index (SOHM) not "
                                f"supported ({HDF5_ITEM})")

    def _add(self, mtype: int, mflags: int, data: bytes,
             order: Optional[int]) -> None:
        if mtype == MSG_NIL:
            return
        self.messages.append((mtype, mflags, data))
        self.order.append(order)

    def _read_v1(self, store: _Store, addr: int) -> None:
        head = store.read(addr, 16)
        version, _, n_msgs, _, size = struct.unpack_from("<BBHII", head)
        if version != 1:
            raise HDF5Error(f"object header version {version} at {addr} not "
                            "supported")
        self.version, self.flags, self.times = 1, 0, b""
        blocks, seen = [(addr + 16, size)], 0
        while blocks and seen < n_msgs:
            start, length = blocks.pop(0)
            block = store.read(start, length)
            pos = 0
            while pos + 8 <= length and seen < n_msgs:
                mtype, msize, mflags = struct.unpack_from("<HHB", block, pos)
                data = block[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                seen += 1
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack_from("<QQ", data))
                self._add(mtype, mflags, data, None)

    def _read_v2(self, store: _Store, addr: int) -> None:
        head = store.read(addr, 6)
        version, flags = head[4], head[5]
        if version != 2:
            raise HDF5Error(f"OHDR version {version} at {addr} not supported")
        extra = (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        size_len = 1 << (flags & 3)
        pre = store.read(addr, 6 + extra + size_len)
        self.version, self.flags = 2, flags
        self.times = pre[6:6 + extra]  # times and attribute phase change
        size = _uint(pre, 6 + extra, size_len)
        chunk = store.read(addr, len(pre) + size + 4)
        _verify(chunk, f"the object header at {addr}")
        blocks = [(chunk, len(pre), len(pre) + size)]
        hsize = 6 if flags & 0x04 else 4
        while blocks:
            block, pos, end = blocks.pop(0)
            while pos + hsize <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", block, pos)
                order = (struct.unpack_from("<H", block, pos + 4)[0]
                         if flags & 0x04 else None)
                data = block[pos + hsize:pos + hsize + msize]
                pos += hsize + msize
                if mtype == MSG_CONTINUATION:
                    c_addr, c_len = struct.unpack_from("<QQ", data)
                    cont = store.checked(c_addr, c_len, b"OCHK")
                    blocks.append((cont, 4, c_len - 4))
                self._add(mtype, mflags, data, order)

    def find(self, mtype: int) -> Optional[bytes]:
        for t, _, data in self.messages:
            if t == mtype:
                return data
        return None

    def types(self) -> set:
        return {t for t, _, _ in self.messages}

    def datatype(self) -> bytes:
        """The datatype message; a committed datatype's (a shared message
        that points at the datatype's own object header) read from
        there."""
        for t, flags, data in self.messages:
            if t == MSG_DATATYPE:
                if flags & 0x2:
                    return _ObjectHeader(self._store, _shared_address(
                        data)).datatype()
                return data
        raise HDF5Error(f"the object header at {self.addr} has no datatype")


def _shared_address(b: bytes) -> Optional[int]:
    """The object header a shared message points at (a committed
    datatype), or None where it is kept in the shared-message index
    (``H5O__shared_decode``: version 1 has 6 reserved bytes and a heap
    address before it, version 3 a type: 2 for a committed datatype, 1
    for the index)."""
    version = b[0]
    if version == 1:
        return struct.unpack_from("<Q", b, 16)[0]
    if version == 2 or (version == 3 and b[1] == 2):
        return struct.unpack_from("<Q", b, 2)[0]
    return None


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


def _lzf_fn():
    from ..ops import _build

    fn = _build.host_library("lzf_decompress.c").tpuseg_lzf_decompress
    if fn.restype is not ctypes.c_int64:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64]
        fn.restype = ctypes.c_int64
    return fn


def lzf_decompress(data: bytes, out_len: int) -> bytes:
    """One LZF block decoded by ``csrc/lzf_decompress.c``; the buffer grows
    by the input's length until the output fits, as h5py's filter does."""
    fn = _lzf_fn()
    out_len = out_len or len(data)
    while True:
        out = np.empty(out_len, np.uint8)
        n = fn(data, len(data), out.ctypes.data, out_len)
        if n >= 0:
            return out[:n].tobytes()
        if n == -2:
            raise HDF5Error("corrupt LZF data")
        out_len += max(len(data), 1)


def _scaleoffset(data: bytes, cd: Sequence[int], dtype: np.dtype) -> bytes:
    """``H5Z_filter_scaleoffset`` decoding: a 21-byte head (minbits, the
    size and bytes of minval), then each value in minbits bits, most
    significant first; integers add minval, D-scale floats divide by
    10**scale and add the minimum; an all-ones value is the fill value.
    The file's values are little-endian (native where h5py wrote them)."""
    scale_type, scale, n, cls, size = cd[:5]
    filavail = cd[7]
    fill = b"".join(struct.pack("<I", v) for v in cd[8:])[:size]
    minbits = _uint(data, 0, 4)
    minval = _uint(data, 5, min(8, data[4]))
    body = data[21:]
    little = dtype.newbyteorder("<")
    if minbits == 8 * size:  # stored whole
        return np.frombuffer(body, little, count=n).astype(dtype).tobytes()
    if cls == 1 and scale_type != 0:
        raise HDF5Error("scale-offset E-scale floats not supported "
                        f"({HDF5_ITEM})")
    if minbits:
        bits = np.unpackbits(np.frombuffer(body, np.uint8))[:n * minbits]
        padded = np.zeros((n, 64), np.uint8)
        padded[:, 64 - minbits:] = bits.reshape(n, minbits)
        raw = np.packbits(padded, axis=1).view(">u8")[:, 0].astype(np.uint64)
    else:
        raw = np.zeros(n, np.uint64)
    is_fill = raw == np.uint64((1 << minbits) - 1) if filavail == 1 else None
    if cls == 0:
        unsigned = np.dtype(f"<u{size}")
        out = (raw + np.uint64(minval)).astype(unsigned).view(little)
    else:
        mn = np.frombuffer(minval.to_bytes(8, "little")[:size], little)[0]
        ftype = little.type
        # (type)(int) / pow(10, D) + min, in the type's own arithmetic
        out = (raw.astype(np.int64).astype(little) / ftype(10.0 ** scale)
               + mn).astype(little)
    if is_fill is not None:
        out = np.where(is_fill, np.frombuffer(fill, little)[0], out).astype(
            little)
    return out.astype(dtype).tobytes()


def _nbit_fn():
    from ..ops import _build

    fn = _build.host_library("nbit_decompress.c").tpuseg_nbit_decompress
    if fn.restype is not ctypes.c_int64:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64] + [ctypes.c_int32] * 4
        fn.restype = ctypes.c_int64
    return fn


def _nbit(data: bytes, cd: Sequence[int]) -> bytes:
    """``H5Z_filter_nbit`` decoding of an integer or float chunk by
    ``csrc/nbit_decompress.c``: each element's ``precision`` bits from bit
    ``offset`` up, most significant first, back to back in one bit stream;
    the other bits read as 0.  The client values: their count, "stored
    whole", the elements, the class (atomic), then the size, byte order,
    precision and offset."""
    if cd[1]:  # a full-precision type: the chunk is stored as it is
        return data
    n = cd[2]
    size, order, precision, offset = cd[4:8]  # an atomic type's
    # (_parse_filters refuses the others)
    out = np.empty(max(n * size, 1), np.uint8)
    rc = _nbit_fn()(bytes(data), len(data), out.ctypes.data, n, size,
                    int(order == NBIT_ORDER_BE), precision, offset)
    if rc == -1:
        raise HDF5Error(f"n-bit chunk of {len(data)} bytes for {n} elements "
                        f"of {precision} bits (the data is corrupt)")
    if rc:
        raise HDF5Error(f"n-bit with precision {precision} at bit {offset} "
                        f"of {size} bytes")
    return out[:n * size].tobytes()


def _unshuffle(data: bytes, itemsize: int) -> bytes:
    if itemsize == 1:
        return data
    n = len(data) // itemsize
    head = np.frombuffer(data, np.uint8, count=n * itemsize)
    out = head.reshape(itemsize, n).T.tobytes()
    return out + data[n * itemsize:]


def _fletcher_strip(data: bytes, where: str) -> bytes:
    """The data without its Fletcher-32 checksum, which must match (or
    match with its 16-bit halves byte-swapped, as the library accepts)."""
    if len(data) < 4:
        raise HDF5Error(f"{where}: chunk shorter than its Fletcher-32 sum")
    body, stored = data[:-4], struct.unpack_from("<I", data, len(data) - 4)[0]
    want = fletcher32(body)
    c = want.to_bytes(4, "little")
    swapped = int.from_bytes(bytes([c[1], c[0], c[3], c[2]]), "little")
    if stored not in (want, swapped):
        raise HDF5Error(f"{where}: Fletcher-32 checksum mismatch (the data "
                        "is corrupt)")
    return body


# ---------------------------------------------------------------------------
# version-2 B-trees, fixed and extensible arrays
# ---------------------------------------------------------------------------


def _btree2_records(store: _Store, addr: int) -> Tuple[int, List[bytes]]:
    """(record type, every record in key order) of a version-2 B-tree."""
    hdr = store.checked(addr, 38, b"BTHD")
    btype = hdr[5]
    node_size, rec_size, depth = struct.unpack_from("<IHH", hdr, 6)
    root, root_nrec, _total = struct.unpack_from("<QHQ", hdr, 16)
    # the library's node geometry (H5B2__hdr_init): the bytes that count
    # the records under a child pointer grow with the depth
    max_nrec = [(node_size - 10) // rec_size]
    cum_max = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _enc_size(max_nrec[0])
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + cum_size[d - 1]
        m = (node_size - (10 + ptr)) // (rec_size + ptr)
        max_nrec.append(m)
        cum_max.append((m + 1) * cum_max[d - 1] + m)
        cum_size.append(_enc_size(cum_max[d]))

    out: List[bytes] = []

    def node(at: int, nrec: int, d: int) -> None:
        if d == 0:
            raw = store.checked(at, 6 + nrec * rec_size + 4, b"BTLF")
            out.extend(raw[6 + i * rec_size:6 + (i + 1) * rec_size]
                       for i in range(nrec))
            return
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        raw = store.checked(at, 6 + nrec * rec_size + (nrec + 1) * ptr + 4,
                            b"BTIN")
        base = 6 + nrec * rec_size
        for i in range(nrec + 1):
            p = base + i * ptr
            node(_uint(raw, p, 8), _uint(raw, p + 8, nrec_size), d - 1)
            if i < nrec:
                out.append(raw[6 + i * rec_size:6 + (i + 1) * rec_size])

    if root != UNDEF and root_nrec:
        node(root, root_nrec, depth)
    return btype, out


def _farray_elements(store: _Store, addr: int) -> Tuple[int, List[bytes]]:
    """(client id, every element) of a fixed array (``FAHD`` / ``FADB``),
    the data block paged or not; an element of an uninitialized page is
    None."""
    hdr = store.checked(addr, 4 + 4 + 8 + 8 + 4, b"FAHD")
    client, esize, page_bits = hdr[5], hdr[6], hdr[7]
    n, dblock = struct.unpack_from("<QQ", hdr, 8)
    if dblock == UNDEF:
        return client, []
    page = 1 << page_bits
    npages = -(-n // page) if n > page else 0
    prefix = 4 + 2 + 8 + (-(-npages // 8) if npages else 0) + 4
    if not npages:
        raw = store.checked(dblock, prefix + n * esize, b"FADB")
        body = raw[prefix - 4:-4]
        return client, [body[i * esize:(i + 1) * esize] for i in range(n)]
    head = store.checked(dblock, prefix, b"FADB")
    bitmap = head[14:prefix - 4]
    out: List[Optional[bytes]] = []
    for p in range(npages):
        count = min(page, n - p * page)
        if not bitmap[p // 8] & (0x80 >> (p % 8)):
            out.extend([None] * count)
            continue
        at = dblock + prefix + p * (page * esize + 4)
        raw = store.read(at, count * esize + 4)
        _verify(raw, f"fixed-array page {p} at {at}")
        out.extend(raw[i * esize:(i + 1) * esize] for i in range(count))
    return client, out


def _earray_elements(store: _Store, addr: int
                     ) -> Tuple[int, Dict[int, bytes]]:
    """(client id, {index: element}) of an extensible array (``EAHD`` /
    ``EAIB`` / ``EASB`` / ``EADB``): the index block's own elements, then
    each super block's data blocks, the first super blocks' data blocks
    addressed from the index block."""
    hdr = store.checked(addr, 4 + 2 + 6 + 6 * 8 + 8 + 4, b"EAHD")
    client, esize, max_bits, ib_elmts, db_min, sb_min_ptrs, page_bits = (
        hdr[5:12])
    max_idx_set = struct.unpack_from("<Q", hdr, 12 + 32)[0]
    iblock = struct.unpack_from("<Q", hdr, 12 + 48)[0]
    out: Dict[int, bytes] = {}
    if iblock == UNDEF:
        return client, out
    # the library's super-block table (H5EA__hdr_init)
    nsblks = 1 + max_bits - _log2(db_min)
    sblk = []  # (data blocks, elements a data block, first index)
    start = 0
    for u in range(nsblks):
        ndb, nel = 1 << (u // 2), (1 << ((u + 1) // 2)) * db_min
        sblk.append((ndb, nel, start))
        start += ndb * nel
    off_size = (max_bits + 7) // 8
    ib_nsblks = 2 * _log2(sb_min_ptrs)
    ndblk_addrs = 2 * (sb_min_ptrs - 1)
    nsblk_addrs = nsblks - ib_nsblks
    raw = store.checked(iblock, 14 + ib_elmts * esize + 8 * (
        ndblk_addrs + nsblk_addrs) + 4, b"EAIB")
    for i in range(min(ib_elmts, max_idx_set)):
        out[i] = raw[14 + i * esize:14 + (i + 1) * esize]
    pos = 14 + ib_elmts * esize
    dblk_addrs = struct.unpack_from(f"<{ndblk_addrs}Q", raw, pos)
    sblk_addrs = struct.unpack_from(f"<{nsblk_addrs}Q", raw,
                                    pos + 8 * ndblk_addrs)
    page = 1 << page_bits

    def data_block(at: int, nel: int, first: int,
                   pages_init: Optional[bytes]) -> None:
        prefix = 4 + 2 + 8 + off_size
        if nel <= page:
            raw = store.checked(at, prefix + nel * esize + 4, b"EADB")
            for e in range(nel):
                if first + e < max_idx_set:
                    out[first + e] = raw[prefix + e * esize:
                                         prefix + (e + 1) * esize]
            return
        store.checked(at, prefix + 4, b"EADB")
        for p in range(nel // page):
            if not pages_init[p // 8] & (0x80 >> (p % 8)):
                continue
            p_at = at + prefix + 4 + p * (page * esize + 4)
            raw = store.read(p_at, page * esize + 4)
            _verify(raw, f"extensible-array page at {p_at}")
            for e in range(page):
                i = first + p * page + e
                if i < max_idx_set:
                    out[i] = raw[e * esize:(e + 1) * esize]

    for u, (ndb, nel, first) in enumerate(sblk):
        first += ib_elmts
        if first >= max_idx_set:
            break
        npages = nel // page if nel > page else 0
        init_size = (npages + 7) // 8
        if u < ib_nsblks:
            d0 = sum(s[0] for s in sblk[:u])
            addrs = dblk_addrs[d0:d0 + ndb]
            inits = [None] * ndb
        else:
            at = sblk_addrs[u - ib_nsblks]
            if at == UNDEF:
                continue
            head = 4 + 2 + 8 + off_size
            sraw = store.checked(at, head + ndb * init_size + 8 * ndb + 4,
                                 b"EASB")
            inits = [sraw[head + d * init_size:head + (d + 1) * init_size]
                     for d in range(ndb)]
            addrs = struct.unpack_from(f"<{ndb}Q", sraw,
                                       head + ndb * init_size)
        for d, at in enumerate(addrs):
            if at != UNDEF:
                data_block(at, nel, first + d * nel, inits[d])
    return client, out


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _unravel(i: int, counts: Sequence[int]) -> List[int]:
    """Row-major coordinates of linear index i over ``counts`` (the first
    count may be unbounded: it is never read)."""
    out = []
    for c in reversed(counts[1:]):
        i, r = divmod(i, c)
        out.append(r)
    return [i] + out[::-1]


class Dataset:
    """An HDF5 dataset; one made in a writable file with ``shape=`` (or
    from ``data=`` with gzip) also takes ``ds[index] = array``."""

    def __init__(self, store: _Store, header: _ObjectHeader, name: str):
        self._store, self.name = store, name
        self.shape, self._maxshape = _parse_dataspace(
            header.find(MSG_DATASPACE))
        filters = header.find(MSG_FILTERS)
        self._filters = _parse_filters(filters) if filters else []
        self._stored, self.dtype, self._convert = _parse_datatype(
            header.datatype())
        fill = header.find(MSG_FILL)
        fill = None if fill is None else _parse_fill(fill)
        if fill is None or len(fill) != self._stored.itemsize:
            fill = bytes(self._stored.itemsize)
        self._fill = np.frombuffer(fill, self._stored)[0]
        external = header.find(MSG_EXTERNAL)
        # external raw storage: (file name, offset in it, bytes) per
        # segment, the dataset's bytes in order
        self._efl = None if external is None else _parse_efl(store, external)
        layout = header.find(MSG_LAYOUT)
        if layout is None or layout[0] not in (3, 4):
            raise HDF5Error(f"{name}: data layout message version "
                            f"{None if layout is None else layout[0]} not "
                            "supported")
        self._layout_class = layout[1]
        self.chunks: Optional[Tuple[int, ...]] = None
        # where a dataset made since the file was opened keeps its chunk
        # B-tree's address (patched when the file closes); None: read only
        self._btree_field: Optional[int] = None
        self._index_type, self._partial_unfiltered = 0, False
        if self._layout_class == 0:  # compact
            size = struct.unpack_from("<H", layout, 2)[0]
            self._compact = layout[4:4 + size]
        elif self._layout_class == 1:  # contiguous
            self._addr = struct.unpack_from("<Q", layout, 2)[0]
        elif self._layout_class == 2 and layout[0] == 3:  # version-1 B-tree
            rank = layout[2]
            self._addr = struct.unpack_from("<Q", layout, 3)[0]
            dims = struct.unpack_from(f"<{rank}I", layout, 11)
            self.chunks = tuple(dims[:-1])
        elif self._layout_class == 2:
            self._parse_layout4(layout)
        elif self._layout_class == 3 and layout[0] == 4:
            self._mappings = _parse_virtual(store, layout, name)
            self._sources: Dict[int, Dataset] = {}
            # sources read as h5py's dtype, and so does the fill value
            fill = np.array([self._fill])
            if self._convert is not None:
                fill = self._convert(fill)
            self._fill = fill.astype(self.dtype)[0]
            self._stored, self._convert = self.dtype, None
        else:
            raise HDF5Error(f"{name}: layout class {self._layout_class} not "
                            "supported")
        self._index: Optional[Dict[Tuple[int, ...],
                                   Tuple[int, int, int]]] = None

    def _parse_layout4(self, layout: bytes) -> None:
        flags, ndims, enc = layout[2], layout[3], layout[4]
        dims = [_uint(layout, 5 + i * enc, enc) for i in range(ndims)]
        self.chunks = tuple(dims[:-1])
        pos = 5 + ndims * enc
        self._index_type = layout[pos]
        pos += 1
        self._partial_unfiltered = bool(flags & 1)
        self._single = None
        if self._index_type == IDX_SINGLE:
            if flags & 2:  # filtered: its stored size and filter mask
                self._single = struct.unpack_from("<QI", layout, pos)
                pos += 12
        elif self._index_type == IDX_FARRAY:
            pos += 1
        elif self._index_type == IDX_EARRAY:
            pos += 5
        elif self._index_type == IDX_BT2:
            pos += 6
        elif self._index_type != IDX_IMPLICIT:
            raise HDF5Error(f"{self.name}: chunk index type "
                            f"{self._index_type} not supported")
        self._addr = struct.unpack_from("<Q", layout, pos)[0]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    @property
    def compression(self) -> Optional[str]:
        for fid, name in COMPRESSION.items():
            if any(f == fid for f, _ in self._filters):
                return name
        return None

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
        out = self._read_box(box)
        if self._convert is not None:
            out = self._convert(out)
        out = out[post]
        return out if out.dtype == self.dtype else out.astype(self.dtype)

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
                block = self._decode_chunk(offset, *entry).copy()
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
        """The hyperslab [start, stop) per axis, in the stored dtype."""
        shape = tuple(b - a for a, b in box)
        sel = tuple(slice(a, b) for a, b in box)
        if self._layout_class == 0:
            full = np.frombuffer(self._compact, self._stored)
            return full[:self.size].reshape(self.shape)[sel].copy()
        if self._layout_class == 3:
            return self._read_virtual(box, shape)
        if self._layout_class == 1:
            if self._efl is not None:
                return self._read_external(box)
            if self._addr == UNDEF:
                return np.full(shape, self._fill, self._stored)
            mm = np.memmap(self._store.path, dtype=self._stored, mode="r",
                           offset=self._addr + self._store.base,
                           shape=self.shape)
            out = np.array(mm[sel])
            del mm
            return out
        return self._read_chunked(box, shape)

    def _read_external(self, box) -> np.ndarray:
        """External raw storage: the whole planes of the box's first axis
        read from the segments' files (short files read as zeros, bytes
        past the last segment as the fill value), then cut to the box."""
        itemsize = self._stored.itemsize
        a, b = box[0] if box else (0, 1)  # a scalar: its one element
        row = int(np.prod(self.shape[1:]))
        start, n = a * row * itemsize, (b - a) * row * itemsize
        out = bytearray(np.full((b - a) * row, self._fill,
                                self._stored).tobytes())
        pos = 0
        for name, offset, size in self._efl:
            end = pos + size
            lo, hi = max(start, pos), min(start + n, end)
            if lo < hi:
                with open(self._store.extfile_path(name), "rb") as f:
                    f.seek(offset + lo - pos)
                    data = f.read(hi - lo)
                out[lo - start:hi - start] = data + bytes(hi - lo - len(data))
            pos = end
        arr = np.frombuffer(bytes(out), self._stored)
        if not box:
            return arr.reshape(())
        arr = arr.reshape((b - a,) + tuple(self.shape[1:]))
        return arr[(slice(None),) + tuple(slice(lo, hi)
                                          for lo, hi in box[1:])]

    def _source(self, i: int) -> Optional["Dataset"]:
        """Mapping i's source dataset, opened at its first read (None where
        its file or dataset cannot be opened: tried again at the next
        read, as the library does)."""
        if i not in self._sources:
            file, dset = self._mappings[i][:2]
            root = (self._store.root() if file == "."
                    else self._store.open_file(file, "HDF5_VDS_PREFIX"))
            try:
                ds = None if root is None else root[dset]
            except (KeyError, HDF5Error):
                ds = None
            if not isinstance(ds, Dataset):
                return None
            self._sources[i] = ds
        return self._sources[i]

    def _read_virtual(self, box, shape) -> np.ndarray:
        """A virtual dataset: the fill value, then each mapping in order
        (a later one over an earlier) where its source opens; only the
        source's region that the box's part of the mapping selects is
        read."""
        out = np.full(shape, self._fill, self.dtype)
        for i, (_, _, src_sel, vir_sel) in enumerate(self._mappings):
            vcoords = _coords(vir_sel, self.shape)
            hit = [np.nonzero((c >= a) & (c < b))[0]
                   for c, (a, b) in zip(vcoords, box)]
            if any(len(h) == 0 for h in hit):
                continue
            src = self._source(i)
            if src is None:
                continue
            scoords = _coords(src_sel, src.shape)
            vshape = [len(c) for c in vcoords]
            sshape = [len(c) for c in scoords]
            if int(np.prod(vshape)) != int(np.prod(sshape)):
                raise HDF5Error(f"{self.name}: mapping {i} selects "
                                f"{vshape} virtual and {sshape} source "
                                "elements")
            vaxes = [k for k, n in enumerate(vshape) if n != 1]
            saxes = [k for k, n in enumerate(sshape) if n != 1]
            grid = [vshape[k] for k in vaxes] == [sshape[k] for k in saxes]
            if grid:  # the same shape but for axes of 1: axis by axis
                pick = [np.zeros(1, np.int64) for _ in sshape]
                for vk, sk in zip(vaxes, saxes):
                    pick[sk] = hit[vk]
            else:  # element i of one selection is element i of the other
                flat = np.ravel_multi_index(np.ix_(*hit), vshape).ravel()
                pick = np.unravel_index(flat, sshape)
            where = [c[p] for c, p in zip(scoords, pick)]
            lo = [int(w.min()) for w in where]
            region = src[tuple(slice(l, int(w.max()) + 1)
                               for l, w in zip(lo, where))]
            rel = [w - l for w, l in zip(where, lo)]
            values = region[_index(rel) if grid else tuple(rel)]
            dst = _index([c[h] - a for c, h, (a, _) in zip(vcoords, hit,
                                                             box)])
            out[dst] = np.asarray(values).reshape(
                [len(h) for h in hit]).astype(self.dtype)
        return out

    def _chunk_bytes(self) -> int:
        return int(np.prod(self.chunks)) * self._stored.itemsize

    def _chunk_index(self) -> Dict[Tuple[int, ...], Tuple[int, int, int]]:
        """{chunk offset: (address, stored size, filter mask)}, from the
        dataset's chunk index, read once."""
        if self._index is None:
            self._index = {}
            if self._addr != UNDEF:
                read = {0: self._index_btree1, IDX_SINGLE: self._index_single,
                        IDX_IMPLICIT: self._index_implicit,
                        IDX_FARRAY: self._index_farray,
                        IDX_EARRAY: self._index_earray,
                        IDX_BT2: self._index_btree2}[self._index_type]
                for scaled, entry in read():
                    self._index[tuple(s * c for s, c in zip(
                        scaled, self.chunks))] = entry
        return self._index

    def _index_btree1(self):
        rank = len(self.shape) + 1
        for key, child in _btree_entries(self._store, self._addr, 1, rank):
            size, mask = struct.unpack_from("<II", key)
            offset = struct.unpack_from(f"<{rank}Q", key, 8)[:-1]
            yield tuple(o // c for o, c in zip(offset, self.chunks)), (
                child, size, mask)

    def _index_single(self):
        size, mask = self._single or (self._chunk_bytes(), 0)
        yield (0,) * len(self.shape), (self._addr, size, mask)

    def _max_counts(self) -> List[int]:
        """Chunks along each axis of the maximum shape (an unlimited axis
        counts as one: it is only ever the slowest)."""
        return [1 if m == UNDEF else -(-m // c)
                for m, c in zip(self._maxshape, self.chunks)]

    def _index_implicit(self):
        """Every chunk of the maximum shape allocated at once, in row-major
        order from the index's address."""
        size = self._chunk_bytes()
        counts = self._max_counts()
        for i in range(int(np.prod(counts))):
            yield _unravel(i, counts), (self._addr + i * size, size, 0)

    def _elements(self, elements, filtered: bool):
        """(address, size, mask) of fixed- or extensible-array elements."""
        size = self._chunk_bytes()
        for i, raw in elements:
            if raw is None:
                continue
            addr = _uint(raw, 0, 8)
            if addr == UNDEF:
                continue
            if filtered:
                n = len(raw) - 12
                yield i, (addr, _uint(raw, 8, n),
                          struct.unpack_from("<I", raw, 8 + n)[0])
            else:
                yield i, (addr, size, 0)

    def _index_farray(self):
        client, elements = _farray_elements(self._store, self._addr)
        counts = self._max_counts()
        for i, entry in self._elements(enumerate(elements), client == 1):
            yield _unravel(i, counts), entry

    def _index_earray(self):
        """The one unlimited axis is the slowest (the library swizzles it
        to the front); the others count chunks of the maximum shape."""
        client, elements = _earray_elements(self._store, self._addr)
        unlim = [k for k, m in enumerate(self._maxshape) if m == UNDEF]
        if len(unlim) != 1:
            raise HDF5Error(f"{self.name}: extensible-array index with "
                            f"{len(unlim)} unlimited axes")
        u = unlim[0]
        order = [u] + [k for k in range(len(self.shape)) if k != u]
        counts = self._max_counts()
        swz = [counts[k] for k in order]
        for i, entry in self._elements(sorted(elements.items()),
                                       client == 1):
            coords = _unravel(i, swz)
            scaled = [0] * len(order)
            for k, c in zip(order, coords):
                scaled[k] = c
            yield scaled, entry

    def _index_btree2(self):
        btype, records = _btree2_records(self._store, self._addr)
        rank = len(self.shape)
        if btype not in (10, 11):
            raise HDF5Error(f"{self.name}: v2 B-tree of record type {btype} "
                            "is not a chunk index")
        size = self._chunk_bytes()
        for rec in records:
            addr = _uint(rec, 0, 8)
            scaled = struct.unpack_from(f"<{rank}Q", rec, len(rec) - 8 * rank)
            if btype == 10:
                yield scaled, (addr, size, 0)
            else:
                n = len(rec) - 8 - 4 - 8 * rank
                yield scaled, (addr, _uint(rec, 8, n),
                               struct.unpack_from("<I", rec, 8 + n)[0])

    def _decode_chunk(self, offset, addr: int, size: int, mask: int
                      ) -> np.ndarray:
        if self._partial_unfiltered and any(
                o + c > n for o, c, n in zip(offset, self.chunks, self.shape)):
            mask = ~0  # edge chunks stored unfiltered
        data = self._store.read(addr, size)
        where = f"{self.name}: chunk at {tuple(offset)}"
        for i in reversed(range(len(self._filters))):
            if mask & (1 << i):
                continue  # this filter was skipped for this chunk
            fid, vals = self._filters[i]
            if fid == FILTER_DEFLATE:
                data = zlib.decompress(data)
            elif fid == FILTER_SHUFFLE:
                data = _unshuffle(data, self._stored.itemsize)
            elif fid == FILTER_FLETCHER32:
                data = _fletcher_strip(data, where)
            elif fid == FILTER_LZF:
                data = lzf_decompress(data, vals[2] if len(vals) > 2 else 0)
            elif fid == FILTER_SZIP:
                try:
                    data = szip.hdf5_chunk(data, vals)
                except ValueError as e:
                    raise HDF5Error(f"{where}: {e}") from None
            elif fid == FILTER_NBIT:
                data = _nbit(data, vals)
            else:
                data = _scaleoffset(data, vals, self._stored)
        n = int(np.prod(self.chunks))
        if len(data) < n * self._stored.itemsize:
            raise HDF5Error(f"{where}: {len(data)} bytes decoded, "
                            f"{n * self._stored.itemsize} expected")
        arr = np.frombuffer(data, self._stored, count=n)
        return arr.reshape(self.chunks)

    def _read_chunked(self, box, shape) -> np.ndarray:
        out = np.full(shape, self._fill, self._stored)
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
            chunk = self._decode_chunk(offset, *entry)
            src, dst = [], []
            for (a, b), o, c in zip(box, offset, self.chunks):
                lo, hi = max(a, o), min(b, o + c)
                src.append(slice(lo - o, hi - o))
                dst.append(slice(lo - a, hi - a))
            out[tuple(dst)] = chunk[tuple(src)]
        return out


def _index(coords: Sequence[np.ndarray]):
    """The numpy index of the grid ``coords`` spans (sorted coordinates per
    axis): slices where every axis is a run, else an open mesh."""
    if all(len(c) == int(c[-1]) - int(c[0]) + 1 for c in coords):
        return tuple(slice(int(c[0]), int(c[-1]) + 1) for c in coords)
    return np.ix_(*coords)


# ---------------------------------------------------------------------------
# external raw storage and virtual datasets
# ---------------------------------------------------------------------------


def _heap_string(store: "_Store", heap: int, offset: int) -> str:
    """The NUL-terminated name at ``offset`` of a local heap's data."""
    head = store.read(heap, 32)
    if head[:4] != b"HEAP":
        raise HDF5Error(f"no local heap at {heap}")
    size, _, data = struct.unpack_from("<QQQ", head, 8)
    raw = store.read(data, size)
    end = raw.find(b"\0", offset)
    if not 0 <= offset < size or end < 0:
        raise HDF5Error(f"name at {offset} outside the local heap at {heap}")
    return raw[offset:end].decode("utf-8")


def _parse_efl(store: "_Store", b: bytes) -> List[Tuple[str, int, int]]:
    """The External Data Files message: (file name, offset in the file,
    bytes) of each segment, the names in a local heap."""
    version, _, used, heap = struct.unpack_from("<B3xHHQ", b)
    if version != 1:
        raise HDF5Error(f"external data files message version {version} not "
                        "supported")
    out = []
    for i in range(used):
        name_at, offset, size = struct.unpack_from("<QQQ", b, 16 + 24 * i)
        out.append((_heap_string(store, heap, name_at), offset,
                    1 << 62 if size == UNDEF else size))
    return out


def _global_heap_object(store: "_Store", addr: int, index: int) -> bytes:
    """Object ``index`` of the global heap collection at ``addr``."""
    head = store.read(addr, 16)
    if head[:4] != b"GCOL":
        raise HDF5Error(f"no global heap collection at {addr}")
    size = struct.unpack_from("<Q", head, 8)[0]
    raw = store.read(addr, size)
    pos = 16
    while pos + 16 <= size:
        oid, _, n = struct.unpack_from("<HH4xQ", raw, pos)
        if oid == 0:  # free space: the end of the objects
            break
        if oid == index:
            return raw[pos + 16:pos + 16 + n]
        pos += 16 + n + (-n % 8)
    raise HDF5Error(f"no object {index} in the global heap at {addr}")


H5S_SEL_NONE, H5S_SEL_HYPER, H5S_SEL_ALL = 0, 2, 3  # 1: points


def _parse_selection(b: bytes, pos: int, what: str):
    """(selection, position after it) of a serialized dataspace selection
    (``H5S_select_serialize``): None for all, else the selected coordinates
    of each axis, sorted; the hyperslab encodings are version 1 (blocks as
    4-byte corners), 2 (regular, 8-byte start / stride / count / block) and
    3 (either, in values of 1-8 bytes).  A hyperslab must be regular: the
    product of its axes' coordinate sets."""
    kind, version = struct.unpack_from("<II", b, pos)
    if kind == H5S_SEL_ALL:
        return None, pos + 16
    if kind == H5S_SEL_NONE:
        return [], pos + 16
    if kind != H5S_SEL_HYPER:
        raise HDF5Error(f"{what}: point selections not supported "
                        f"({HDF5_ITEM})")
    regular, blocks = None, None
    if version == 1:
        rank, nblocks = struct.unpack_from("<II", b, pos + 16)
        pos += 24
        corners = struct.unpack_from(f"<{2 * rank * nblocks}I", b, pos)
        pos += 8 * rank * nblocks
        blocks = [(corners[2 * rank * k:2 * rank * k + rank],
                   corners[2 * rank * k + rank:2 * rank * (k + 1)])
                  for k in range(nblocks)]
    elif version == 2:
        rank = struct.unpack_from("<I", b, pos + 13)[0]
        pos += 17
        regular = struct.unpack_from(f"<{4 * rank}Q", b, pos)
        pos += 32 * rank
        unlimited = UNDEF
    elif version == 3:
        flags, enc, rank = struct.unpack_from("<BBI", b, pos + 8)
        pos += 14
        unlimited = (1 << (8 * enc)) - 1

        def values(n):
            nonlocal pos
            out = [_uint(b, pos + enc * i, enc) for i in range(n)]
            pos += enc * n
            return out

        if flags & 1:
            regular = values(4 * rank)
        else:
            nblocks = values(1)[0]
            corners = values(2 * rank * nblocks)
            blocks = [(corners[2 * rank * k:2 * rank * k + rank],
                       corners[2 * rank * k + rank:2 * rank * (k + 1)])
                      for k in range(nblocks)]
    else:
        raise HDF5Error(f"{what}: hyperslab selection version {version} not "
                        "supported")
    if regular is not None:
        if unlimited in regular:
            raise HDF5Error(f"{what}: an unlimited selection not supported "
                            f"({HDF5_ITEM})")
        axes = []
        for d in range(rank):
            start, stride, count, block = regular[4 * d:4 * d + 4]
            axes.append(np.unique((start + stride * np.arange(
                count, dtype=np.int64))[:, None] + np.arange(block)))
        return axes, pos
    axes = [np.unique(np.concatenate([np.arange(lo[d], hi[d] + 1)
                                      for lo, hi in blocks]))
            for d in range(rank)] if blocks else []
    volume = sum(int(np.prod([h - l + 1 for l, h in zip(lo, hi)]))
                 for lo, hi in blocks)
    if blocks and volume != int(np.prod([len(a) for a in axes])):
        raise HDF5Error(f"{what}: an irregular hyperslab selection not "
                        f"supported ({HDF5_ITEM})")
    return axes, pos


def _coords(sel, shape) -> List[np.ndarray]:
    """The selected coordinates of each axis (all of ``shape`` for None)."""
    if sel is None:
        return [np.arange(n) for n in shape]
    if not sel:  # the empty selection
        return [np.zeros(0, np.int64) for _ in shape]
    return sel


def _vds_name(raw: bytes, what: str) -> str:
    """A source file or dataset name; "%%" is a literal "%", any other "%"
    names blocks of an unlimited mapping."""
    name = raw.decode("utf-8")
    if "%" in name.replace("%%", ""):
        raise HDF5Error(f"{what}: printf-named source {name!r} not supported "
                        f"({HDF5_ITEM})")
    return name.replace("%%", "%")


def _parse_virtual(store: "_Store", layout: bytes, name: str) -> list:
    """A virtual dataset's mappings, (source file, source dataset, source
    selection, virtual selection) each, from the global heap object the
    layout message points at (version 0: the count, then the mappings,
    then a lookup3 checksum)."""
    addr, index = struct.unpack_from("<QI", layout, 2)
    if addr == UNDEF:
        return []
    raw = _global_heap_object(store, addr, index)
    if raw[0] != 0:
        raise HDF5Error(f"{name}: virtual dataset mapping encoding version "
                        f"{raw[0]} not supported")
    _verify(raw, f"{name}: the virtual dataset's mappings")
    n, pos, out = struct.unpack_from("<Q", raw, 1)[0], 9, []
    for i in range(n):
        names = []
        for _ in range(2):
            end = raw.index(b"\0", pos)
            names.append(_vds_name(raw[pos:end], f"{name}: virtual dataset"))
            pos = end + 1
        what = f"{name}: virtual dataset mapping {i}"
        src, pos = _parse_selection(raw, pos, what)
        vir, pos = _parse_selection(raw, pos, what)
        out.append((names[0], names[1], src, vir))
    return out


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


# ---------------------------------------------------------------------------
# links: fractal heaps, Link messages
# ---------------------------------------------------------------------------


class _FractalHeap:
    """The managed and tiny objects of a fractal heap (``FRHP``), its
    direct blocks (``FHDB``) found through the doubling table of indirect
    blocks (``FHIB``)."""

    def __init__(self, store: _Store, addr: int):
        self._store = store
        head = store.read(addr, 146)
        if head[:4] != b"FRHP":
            raise HDF5Error(f"no fractal heap at {addr}")
        filter_len, flags = struct.unpack_from("<HB", head, 7)
        if filter_len:
            raise HDF5Error(f"fractal heap at {addr}: filtered heaps not "
                            f"supported ({HDF5_ITEM})")
        _verify(head, f"the fractal heap header at {addr}")
        self._checked_dblocks = bool(flags & 2)
        max_man = struct.unpack_from("<I", head, 10)[0]
        width, start, max_direct, max_bits, _, root, rows = struct.unpack_from(
            "<HQQHHQH", head, 110)
        self._width, self._root, self._rows = width, root, rows
        self._off_size = (max_bits + 7) // 8
        self._len_size = min((_log2(max_direct) + 7) // 8, _enc_size(max_man))
        start_bits = _log2(start)
        self._first_row_bits = start_bits + _log2(width)
        self._max_direct_rows = _log2(max_direct) - start_bits + 2
        max_rows = max_bits - self._first_row_bits + 1
        self._row_size, self._row_off = [start], [0]
        size, off = start, start * width
        for _ in range(1, max_rows):
            self._row_size.append(size)
            self._row_off.append(off)
            size, off = size * 2, off * 2
        self._start = start
        self._blocks: Optional[List[Tuple[int, int, int]]] = None

    def _direct_blocks(self) -> List[Tuple[int, int, int]]:
        """(heap offset, size, address) of every allocated direct block."""
        if self._blocks is None:
            self._blocks = []
            if self._root != UNDEF:
                if self._rows == 0:
                    self._blocks.append((0, self._start, self._root))
                else:
                    self._indirect(self._root, self._rows, 0)
        return self._blocks

    def _indirect(self, addr: int, rows: int, base: int) -> None:
        n_direct = min(rows, self._max_direct_rows) * self._width
        n_entries = rows * self._width
        head = 4 + 1 + 8 + self._off_size
        raw = self._store.checked(addr, head + 8 * n_entries + 4, b"FHIB")
        for k in range(n_entries):
            child = _uint(raw, head + 8 * k, 8)
            if child == UNDEF:
                continue
            r, c = divmod(k, self._width)
            size = self._row_size[r]
            off = base + self._row_off[r] + c * size
            if k < n_direct:
                self._blocks.append((off, size, child))
            else:
                self._indirect(child, _log2(size) - self._first_row_bits + 1,
                               off)

    def object(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:  # tiny: the object is in the ID
            if len(heap_id) <= 18:
                n = (heap_id[0] & 0x0F) + 1
                return heap_id[1:1 + n]
            n = (((heap_id[0] & 0x0F) << 8) | heap_id[1]) + 1
            return heap_id[2:2 + n]
        if kind != 0:
            raise HDF5Error(f"huge fractal-heap objects not supported "
                            f"({HDF5_ITEM})")
        off = _uint(heap_id, 1, self._off_size)
        n = _uint(heap_id, 1 + self._off_size, self._len_size)
        for start, size, addr in self._direct_blocks():
            if start <= off < start + size:
                block = self._store.read(addr, size)
                if block[:4] != b"FHDB":
                    raise HDF5Error(f"no fractal heap direct block at {addr}")
                if self._checked_dblocks:
                    at = 4 + 1 + 8 + self._off_size
                    stored = struct.unpack_from("<I", block, at)[0]
                    zeroed = block[:at] + b"\0" * 4 + block[at + 4:]
                    if lookup3(zeroed) != stored:
                        raise HDF5Error(f"bad checksum in the fractal heap "
                                        f"direct block at {addr} (the file "
                                        "is corrupt)")
                return block[off - start:off - start + n]
        raise HDF5Error(f"fractal heap object at offset {off} is in no "
                        "direct block")


def _parse_link(b: bytes) -> Tuple[str, tuple, Optional[int]]:
    """(name, target, creation order) of a Link message; the target is
    ("hard", header address), ("soft", path), ("external", file, path,
    value) or ("user-defined", link type, value), ``value`` the link's
    stored bytes."""
    if b[0] != 1:
        raise HDF5Error(f"link message version {b[0]} not supported")
    flags, pos = b[1], 2
    ltype = 0
    if flags & 0x08:
        ltype, pos = b[pos], pos + 1
    order = None
    if flags & 0x04:
        order, pos = struct.unpack_from("<Q", b, pos)[0], pos + 8
    if flags & 0x10:
        pos += 1  # the name's character set
    n_len = 1 << (flags & 3)
    n = _uint(b, pos, n_len)
    pos += n_len
    name = b[pos:pos + n].decode("utf-8")
    pos += n
    if ltype == 0:
        return name, ("hard", struct.unpack_from("<Q", b, pos)[0]), order
    size = struct.unpack_from("<H", b, pos)[0]
    value = b[pos + 2:pos + 2 + size]
    if ltype == 1:
        return name, ("soft", value.decode("utf-8")), order
    if ltype == 64:  # a flags byte, then the file and the object path
        file, path = value[1:].split(b"\0")[:2]
        return name, ("external", file.decode("utf-8"),
                      path.decode("utf-8"), value), order
    return name, ("user-defined", ltype, value), order


LINK_TYPES = {"hard": 0, "soft": 1, "external": 64}


def _link_message(name: str, target: tuple, order: Optional[int]) -> bytes:
    """A Link message (version 1) for any link ``_parse_link`` reads: an
    external or user-defined link keeps the bytes of its value."""
    raw = name.encode("utf-8")
    code = 0 if len(raw) < 1 << 8 else 1 if len(raw) < 1 << 16 else 2
    flags = code | (0x04 if order is not None else 0)
    ltype = LINK_TYPES.get(target[0], target[1])
    flags |= 0x08 if ltype else 0
    flags |= 0x10 if not raw.isascii() else 0
    out = bytes([1, flags]) + (bytes([ltype]) if ltype else b"")
    out += struct.pack("<Q", order) if order is not None else b""
    out += b"\1" if not raw.isascii() else b""
    out += len(raw).to_bytes(1 << code, "little") + raw
    if ltype == 0:
        return out + struct.pack("<Q", target[1])
    value = target[1].encode("utf-8") if ltype == 1 else target[-1]
    return out + struct.pack("<H", len(value)) + value


# ---------------------------------------------------------------------------
# groups and the file
# ---------------------------------------------------------------------------


class Group:
    """An HDF5 group.  ``_links`` maps each member's name, in h5py's
    ``keys()`` order, to its target: ("hard", object header address),
    ("soft", path), ("external", file, path, value) or ("user-defined",
    type, value).

    A symbol-table group also keeps ``_entries``: name → (heap offset of
    the name, the 32 bytes of its symbol-table entry after the name: object
    header address, cache type, scratch pad).  A link-message group keeps
    its object header (``_header``) and its Link Info message fields, and
    is rewritten whole when it gains a member; the one address that points
    at its object header is then patched: its link in ``parent`` (held
    weakly, so that a closed file's objects are freed by reference
    counting), or for the root the superblock's."""

    def __init__(self, store: _Store, name: str, header: int,
                 new: Optional[Tuple[int, int]] = None,
                 parent: Optional["Group"] = None):
        self._store, self.name, self._header_addr = store, name, header
        self._linked_from = None if parent is None else weakref.ref(parent)
        self._children: Dict[str, object] = {}
        if new is not None:  # an empty symbol-table group; offset 0 holds ""
            self._btree, self._heap = new
            self._heap_data, self._entries = bytearray(8), {}
            self._links: Dict[str, tuple] = {}
            return
        oh = _ObjectHeader(store, header)
        stab = oh.find(MSG_SYMBOL_TABLE)
        if stab is not None:
            self._btree, self._heap = struct.unpack_from("<QQ", stab)
            self._heap_data, self._entries, self._links = _read_symbol_table(
                store, self._btree, self._heap, name)
        elif MSG_LINK_INFO in oh.types() or MSG_LINK in oh.types():
            self._read_links(oh)
        else:
            raise HDF5Error(f"group {name}: no symbol table and no link "
                            "messages")

    # -- link-message groups -------------------------------------------------

    def _read_links(self, oh: _ObjectHeader) -> None:
        self._header, self._entries = oh, None
        info = oh.find(MSG_LINK_INFO)
        flags = info[1] if info else 0
        pos = 2
        self._linfo_flags = flags
        self._max_order = None
        if flags & 1:
            self._max_order = struct.unpack_from("<Q", info, pos)[0]
            pos += 8
        heap, names = (struct.unpack_from("<QQ", info, pos) if info
                       else (UNDEF, UNDEF))
        found = []  # (creation order, name, target)
        if heap == UNDEF:  # compact: the Link messages are in the header
            for mtype, _, data in oh.messages:
                if mtype == MSG_LINK:
                    name, target, order = _parse_link(data)
                    found.append((order, name, target))
        else:  # dense: a fractal heap under a v2 B-tree name index
            fheap = _FractalHeap(self._store, heap)
            btype, records = _btree2_records(self._store, names)
            if btype != 5:
                raise HDF5Error(f"group {self.name}: name index of record "
                                f"type {btype}")
            for rec in records:
                name, target, order = _parse_link(fheap.object(rec[4:]))
                found.append((order, name, target))
        # h5py lists a group that tracks creation order in that order,
        # any other by name
        if flags & 1 and all(o is not None for o, _, _ in found):
            found.sort(key=lambda t: t[0])
        else:
            found.sort(key=lambda t: t[1].encode("utf-8"))
        self._links = {name: target for _, name, target in found}
        self._orders = {name: order for order, name, _ in found}

    def _flush_links(self) -> None:
        """The object header written anew at the end of the file: its
        messages but the links and the Link Info, then the Link Info with
        no dense storage and every link as a Link message; then the
        address that points at it patched."""
        oh = self._header
        for mtype, _, data in oh.messages:
            if (mtype == MSG_REFCOUNT
                    and struct.unpack_from("<I", data, 1)[0] > 1):
                raise HDF5Error(f"group {self.name}: a group with more than "
                                "one hard link is not appended to "
                                f"({HDF5_ITEM})")
        kept = [(t, f, o, d) for (t, f, d), o in zip(oh.messages, oh.order)
                if t not in (MSG_LINK, MSG_LINK_INFO, MSG_CONTINUATION)]
        flags = self._linfo_flags
        info = bytes([0, flags])
        if flags & 1:
            info += struct.pack("<Q", self._max_order)
        info += struct.pack("<QQ", UNDEF, UNDEF)
        if flags & 2:
            info += struct.pack("<Q", UNDEF)
        msgs = [(MSG_LINK_INFO, 0, 0, info)] + kept
        for name, target in self._links.items():
            msgs.append((MSG_LINK, 0, 0, _link_message(
                name, target, self._orders.get(name))))
        flags = oh.flags if oh.version == 2 else 0
        raw = _ohdr_v2(flags, oh.times if oh.version == 2 else b"", msgs)
        addr = self._store.append(raw)
        self._header = _ObjectHeader(self._store, addr)
        self._header_addr = addr
        if self._linked_from is None:
            self._set_root(addr)
        else:
            self._linked_from()._retarget(self.name.rsplit("/", 1)[-1],
                                          addr)

    # -- reading -------------------------------------------------------------

    def keys(self) -> List[str]:
        return list(self._links)

    def __contains__(self, path: str) -> bool:
        """As h5py answers: the groups on the path must open, and the last
        name be linked in its group, the link dangling or not."""
        head, _, last = path.rstrip("/").rpartition("/")
        if not last or last == ".":
            return True
        try:
            group = self[head or ("/" if path.startswith("/") else ".")]
        except KeyError:
            return False
        return isinstance(group, Group) and last in group._links

    def __getitem__(self, path: str):
        """The object at ``path``, soft and external links followed (16 at
        most, the library's limit); an external link's file opens read
        only at its first use and closes with this file."""
        node, hops = self, 0
        if path.startswith("/"):
            node = self._store.root()
        parts = [p for p in path.split("/") if p and p != "."]
        while parts:
            part = parts.pop(0)
            if not isinstance(node, Group) or part not in node._links:
                raise KeyError(f"no object {path!r} in {self.name!r}")
            target = node._links[part]
            if target[0] in ("soft", "external"):
                hops += 1
                if hops > 16:
                    raise KeyError(f"{path!r}: too many links")
            if target[0] == "soft":  # resolve by path, as the library does
                soft = target[1]
                if soft.startswith("/"):
                    node = node._store.root()
                parts = [p for p in soft.split("/") if p and p != "."] + parts
                continue
            if target[0] == "external":  # from the target file's root
                file = node._store.open_file(target[1], "HDF5_EXT_PREFIX")
                if file is None:
                    raise KeyError(f"{path!r}: external link to "
                                   f"{target[1]}:{target[2]}: can't open "
                                   "file")
                node = file
                parts = [p for p in target[2].split("/")
                         if p and p != "."] + parts
                continue
            node = node._open(part)
        return node

    def _open(self, name: str):
        if name not in self._children:
            full = f"{self.name.rstrip('/')}/{name}"
            target = self._links[name]
            if target[0] != "hard":
                raise HDF5Error(f"{full}: link of type {target[1]} not "
                                f"supported ({HDF5_ITEM})")
            header = _ObjectHeader(self._store, target[1])
            types = header.types()
            if types & {MSG_SYMBOL_TABLE, MSG_LINK_INFO, MSG_LINK}:
                child = Group(self._store, full, target[1],
                              parent=self)
            elif MSG_LAYOUT in types:
                child = Dataset(self._store, header, full)
            elif MSG_DATATYPE in types:
                child = Datatype(header, full)
            else:
                raise HDF5Error(f"{full}: object with messages "
                                f"{sorted(types)} is neither a group nor a "
                                "dataset")
            self._children[name] = child
        return self._children[name]

    # -- writing -------------------------------------------------------------

    def _retarget(self, name: str, header: int) -> None:
        """Point ``name`` at a rewritten object header."""
        self._links[name] = ("hard", header)
        if self._entries is not None:
            offset, tail = self._entries[name]
            self._entries[name] = (offset, struct.pack("<Q", header)
                                   + tail[8:])
        self._store.mark(self)

    def _link(self, name: str, header: int, scratch: Optional[bytes] = None
              ) -> None:
        """Add ``name`` → the object header at ``header``; ``scratch`` is a
        subgroup's cached (B-tree, heap) addresses."""
        self._links[name] = ("hard", header)
        self._store.mark(self)
        if self._entries is None:
            if self._max_order is not None:
                self._orders[name] = self._max_order
                self._max_order += 1
            return
        offset = len(self._heap_data)
        raw = name.encode("utf-8") + b"\0"
        self._heap_data += raw + b"\0" * (-len(raw) % 8)
        tail = struct.pack("<QI4x", header, 0 if scratch is None else 1)
        self._entries[name] = (offset, tail + (scratch or b"\0" * 16))

    def _flush(self) -> None:
        """A symbol-table group: the heap's data and the symbol-table nodes
        at the end of the file, the B-tree's root node and the heap header
        in place.  A link-message group: its object header anew."""
        if self._entries is None:
            self._flush_links()
            return
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


class Datatype:
    """A committed (named) datatype; ``dtype`` is the one h5py gives."""

    def __init__(self, header: _ObjectHeader, name: str):
        self.name = name
        self.dtype = _parse_datatype(header.datatype())[1]


def _read_symbol_table(store: _Store, btree: int, heap: int, name: str):
    head = store.read(heap, 32)
    if head[:4] != b"HEAP":
        raise HDF5Error(f"group {name}: no local heap at {heap}")
    heap_size, _, heap_data = struct.unpack_from("<QQQ", head, 8)
    names = store.read(heap_data, heap_size)

    def string(at: int) -> str:
        return names[at:names.index(b"\0", at)].decode("utf-8")

    entries: Dict[str, Tuple[int, bytes]] = {}
    links: Dict[str, tuple] = {}
    for _, snod in _btree_entries(store, btree, 0):
        node = store.read(snod, 8)
        if node[:4] != b"SNOD":
            raise HDF5Error(f"group {name}: no symbol table node at {snod}")
        count = struct.unpack_from("<H", node, 6)[0]
        raw = store.read(snod + 8, 40 * count)
        for i in range(count):
            name_off, header, cache = struct.unpack_from("<QQI", raw, 40 * i)
            key = string(name_off)
            entries[key] = (name_off, raw[40 * i + 8:40 * i + 40])
            if cache == 2:  # a soft link: its value's heap offset
                links[key] = ("soft", string(
                    struct.unpack_from("<I", raw, 40 * i + 24)[0]))
            else:
                links[key] = ("hard", header)
    data = bytearray(names)
    data += b"\0" * (-len(data) % 8)
    return data, entries, links


class File(Group):
    """An HDF5 file: ``"r"`` to read, ``"r+"`` to read and add datasets,
    ``"w"`` to create (truncating)."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "r+", "w"):
            raise ValueError(f"mode {mode!r}: 'r', 'r+' or 'w'")
        self.path, self.mode = os.fspath(path), mode
        store = _Store(self.path, mode)
        store.root = weakref.ref(self)
        try:
            if mode == "w":
                header, btree, heap = _new_group(store, reserve=96)
                super().__init__(store, "/", header, new=(btree, heap))
                store.mark(self)
                self._write_superblock(header)
            else:
                header = self._read_superblock(store)
                super().__init__(store, "/", header)
        except BaseException:
            store.close()
            raise

    def _read_superblock(self, store: _Store) -> int:
        """The root group's object header address; the K values, the
        superblock version and where its root address and end of file lie
        kept for appends.  The superblock is at 0 or, after a user block,
        at 512, 1024, 2048, ...; every address counts from it."""
        size, at = store.eof, 0
        while os.pread(store.fd, 8, at) != SIGNATURE:
            at = max(512, 2 * at)
            if at + 8 > size:
                raise HDF5Error(f"{self.path}: not an HDF5 file (no "
                                "signature at offset 0 or after a user "
                                "block)")
        store.base, store.eof = at, size - at
        sb = store.read(0, min(96, store.eof))
        version = store.sb_version = sb[8]
        if version > 3:
            raise HDF5Error(f"{self.path}: superblock version {version} not "
                            "supported (0-3 are)")
        sizes = (sb[13], sb[14]) if version < 2 else (sb[9], sb[10])
        if sizes != (8, 8):
            raise HDF5Error(f"{self.path}: offsets of {sizes[0]} and lengths "
                            f"of {sizes[1]} bytes not supported")
        if version >= 2:
            _verify(sb[:48], f"{self.path}: the superblock")
            base, ext, eof, root = struct.unpack_from("<QQQQ", sb, 12)
            self._eof_field, self._root_field = 28, 36
            if ext != UNDEF:
                self._read_extension(store, ext)
        else:
            at = 24 if version == 0 else 28
            store.leaf_k, store.node_k = struct.unpack_from("<HH", sb, 16)
            if version == 1:
                store.chunk_k = struct.unpack_from("<H", sb, 24)[0]
            base, _, eof = struct.unpack_from("<QQQ", sb, at)
            self._eof_field = at + 16
            # the root symbol-table entry: name offset, then the header
            self._root_field = at + 32 + 8
            root = struct.unpack_from("<Q", sb, self._root_field)[0]
        if base != store.base:
            raise HDF5Error(f"{self.path}: base address {base} with the "
                            f"superblock at {store.base} not supported")
        store.eof = max(store.eof, eof - base)  # the field counts the user
        # block in, the addresses do not
        return root

    def _read_extension(self, store: _Store, addr: int) -> None:
        """A superblock extension: its B-tree K values (its other messages
        change nothing this codec reads or appends)."""
        for mtype, _, data in _ObjectHeader(store, addr).messages:
            if mtype == MSG_BTREE_K:
                store.chunk_k, store.node_k, store.leaf_k = (
                    struct.unpack_from("<HHH", data, 1))

    def _set_root(self, header: int) -> None:
        self._header_addr = header
        self._store.write(self._root_field, struct.pack("<Q", header))

    def _write_superblock(self, root: int) -> None:
        sb = SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
        sb += struct.pack("<HHI", GROUP_LEAF_K, GROUP_NODE_K, 0)
        sb += struct.pack("<QQQQ", 0, UNDEF, self._store.eof, UNDEF)
        sb += struct.pack("<QQI4xQQ", 0, root, 1, self._btree, self._heap)
        self._store.write(0, sb)
        self._eof_field = 40

    def close(self) -> None:
        """Write what was added since the file was opened (chunk B-trees,
        groups deepest first, the end-of-file address) and close the
        file."""
        store = self._store
        if store.fd is None:
            return
        try:
            if store.dirty:
                for obj in store.dirty:
                    if isinstance(obj, Dataset):
                        obj._flush()
                done: List[Group] = []
                while True:  # a rewritten group marks its parent
                    todo = [g for g in store.dirty if isinstance(g, Group)
                            and not any(g is d for d in done)]
                    if not todo:
                        break
                    g = max(todo, key=lambda g: len(
                        [p for p in g.name.split("/") if p]))
                    g._flush()
                    done.append(g)
                store.write(self._eof_field,
                            struct.pack("<Q", store.eof + store.base))
                if store.sb_version >= 2:
                    sb = store.read(0, 44)
                    store.write(44, struct.pack("<I", lookup3(sb)))
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
            if part not in group._links:
                header, btree, heap = _new_group(self._store)
                group._link(part, header, struct.pack("<QQ", btree, heap))
                group._children[part] = Group(
                    self._store, f"{group.name.rstrip('/')}/{part}", header,
                    new=(btree, heap),
                    parent=group)
                self._store.mark(group._children[part])
            group = group[part]
            if not isinstance(group, Group):
                raise ValueError(f"{name}: {part} is a dataset")
            if group._store is not self._store:
                raise ValueError(f"{name}: {part} is in another file (an "
                                 "external link); datasets are made in "
                                 "this one")
        if parts[-1] in group._links:
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


def _ohdr_v2(flags: int, times: bytes,
             messages: Sequence[Tuple[int, int, Optional[int], bytes]]
             ) -> bytes:
    """A version-2 object header of one chunk: ``flags`` (its size field's
    width is chosen here), the times and phase-change fields ``times``,
    then each (type, flags, creation order, data), and the checksum."""
    order = flags & 0x04
    body = b"".join(struct.pack("<BHB", t, len(d), f)
                    + (struct.pack("<H", o or 0) if order else b"") + d
                    for t, f, o, d in messages)
    code = next(c for c in range(4) if len(body) < 1 << (8 << c))
    raw = (b"OHDR" + bytes([2, (flags & ~3) | code]) + times
           + len(body).to_bytes(1 << code, "little") + body)
    return raw + struct.pack("<I", lookup3(raw))


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
    """Version-1 B-tree nodes of type 1 (2K entries each, K the file's)
    over the chunks ``entries`` ((offset, size, address), in offset
    order), built bottom-up; each key is (size, mask, offset..., 0) and the
    last key of a node is the chunk after its last child.  Returns the
    root's address."""
    ndim = len(chunks)

    def key(size, offset):
        return struct.pack("<II", size, 0) + struct.pack(
            f"<{ndim + 1}Q", *offset, 0)

    end = tuple(o + c for o, c in zip(entries[-1][0], chunks))
    level, nodes = 0, entries
    key_size = 8 + 8 * (ndim + 1)
    k2 = 2 * store.chunk_k
    node_size = 24 + k2 * 8 + (k2 + 1) * key_size
    while True:
        groups = [nodes[i:i + k2] for i in range(0, len(nodes), k2)]
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
