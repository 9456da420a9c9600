"""The HDF5 files the port's codec (``utils/hdf5.py``) once refused, against
h5py, exactly: values, dtypes, shapes, fill values and errors.

- the committed fixtures of ``tests/fixtures/h5_item20`` against
  ``manifest.json`` in h5py and in the port (which ``chip_smoke.py``'s
  phase 30 holds the card machine to);
- szip (``csrc/szip_decompress.c``): EC and NN, 8 / 16 / 32 pixels a
  block, u1 / i1 / u2 / i2 / u4 / i4 / f4 / f8 / i8 in both byte orders,
  partial chunks, padded and split scanlines, 24-bit samples, a chunk the
  optional filter left raw, a corrupt stream;
- n-bit (``csrc/nbit_decompress.c``): integers of 1-8 bytes at several
  precisions and offsets, signed, both byte orders, a reduced float, n-bit
  under deflate; the C decoder against a plain bit walk;
- virtual datasets: strided and blocked selections on both sides,
  overlapping mappings, "." sources, relative sources opened from another
  working directory, missing source files and datasets (the fill value),
  superblock 0 and latest encodings, "%%" in a source name, random
  region reads; unlimited and printf-named mappings still refused;
- external links: relative, absolute (and an absolute one whose directory
  is gone), to groups, chained through soft and external links,
  ``HDF5_EXT_PREFIX`` and ``${ORIGIN}``, dangling (``KeyError``, and
  ``in`` as h5py answers), cycles; the targets close with the file;
- external raw storage: two segments, resolved from the working directory
  or ``HDF5_EXTFILE_PREFIX``, a short raw file (zeros), a missing one
  (``OSError`` in both);
- committed datatypes, and integers with unused bits;
- a Lazy memo appended beside an external link (the link messages
  re-encoded with their stored bytes), read back by h5py with the links;
- the JAX package's ``StandardHDF5Dataset`` and ``LazyHDF5Dataset``
  (h5py) against the port's over a VDS, an external link and szip."""

import json
import os
import shutil

import h5py
import numpy as np
import pytest

from mdeical_image_segmentation_tpu_torch.utils import hdf5

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
ITEM20 = os.path.join(FIXTURES, "h5_item20")
HDF5_ITEM = "ROADMAP.md queue 1, item 20"


def _check_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _fixture_script():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_port_fixtures", os.path.join(os.path.dirname(FIXTURES), "..",
                                           "scripts",
                                           "make_port_fixtures.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)["h5_item20"]


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_item20_fixtures_match_the_manifest_in_h5py_and_the_port(
        name, tmp_path, monkeypatch):
    """h5py reads the manifest from the committed files (from their
    directory, where external raw files are named); the port reads the
    same from another directory, external raw files under
    ``HDF5_EXTFILE_PREFIX=${ORIGIN}``."""
    script = _fixture_script()
    want = _manifest()[name]
    monkeypatch.chdir(ITEM20)
    assert script.h5_manifest(h5py, name) == want
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("HDF5_EXTFILE_PREFIX", "${ORIGIN}")
    with hdf5.File(os.path.join(ITEM20, name)) as g:
        for group, keys in want["groups"].items():
            assert g[group].keys() == keys
        for ds, entry in want["datasets"].items():
            assert script.entry(g[ds][()]) == entry, ds


def _same_file(path):
    """Every dataset reachable from the root reads equal in the port, and
    every dangling link raises KeyError in both."""
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        def walk(a, b):
            assert list(a.keys()) == b.keys(), a.name
            for k in a.keys():
                try:
                    obj = a[k]
                except KeyError:  # a dangling link
                    with pytest.raises(KeyError):
                        b[k]
                    continue
                if isinstance(obj, h5py.Group):
                    walk(obj, b[k])
                elif isinstance(obj, h5py.Dataset):
                    _check_equal(b[k][()], obj[()])
        walk(f, g)


# -- szip ---------------------------------------------------------------------

SZIP_DTYPES = ["|u1", "|i1"] + [f"{o}{t}" for t in ("u2", "i2", "u4", "i4",
                                                     "f4", "f8", "i8")
                                for o in "<>"]


def _signal(dtype, shape, seed):
    """Smooth runs, noise and zeros: every option of the coder shows up."""
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    a = np.cumsum(rng.integers(-3, 4, shape), axis=-1).astype(np.float64)
    a[..., ::7] += rng.standard_normal(a[..., ::7].shape) * 300
    a[..., 1:3] = 0
    if dt.kind in "iu":
        info = np.iinfo(dt)
        a = np.clip(a + (0 if dt.kind == "i" else 40), info.min, info.max)
    return a.astype(dt)


@pytest.mark.parametrize("ppb", [8, 16, 32])
@pytest.mark.parametrize("option", ["ec", "nn"])
@pytest.mark.parametrize("dtype", SZIP_DTYPES)
def test_szip_reads_equal(tmp_path, dtype, option, ppb):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=_signal(dtype, (5, 9, 37), ppb),
                         chunks=(2, 4, 37), compression="szip",
                         compression_opts=(option, ppb))
    _same_file(path)
    with hdf5.File(path) as g:
        assert g["x"].compression == "szip"


def _szip_dataset(f, name, data, chunks, mask, ppb, tid=None):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_chunk(chunks)
    dcpl.set_filter(h5py.h5z.FILTER_SZIP, h5py.h5z.FLAG_OPTIONAL,
                    (mask, ppb))
    ds = h5py.h5d.create(f.id, name.encode(),
                         tid or h5py.h5t.py_create(data.dtype),
                         h5py.h5s.create_simple(data.shape), dcpl=dcpl)
    ds.write(h5py.h5s.ALL, h5py.h5s.ALL, data)


def test_szip_scanlines_padded_split_and_24_bit(tmp_path):
    """A last axis shorter than a block (scanlines of the whole chunk,
    padded to whole blocks), longer than 128 blocks (scanlines of 128
    blocks, the last one partial), an odd scanline, and a 4-byte integer
    of precision 24 (24-bit samples in 4 bytes)."""
    path = str(tmp_path / "f.h5")
    nn, ec = h5py.h5z.SZIP_NN_OPTION_MASK, h5py.h5z.SZIP_EC_OPTION_MASK
    with h5py.File(path, "w") as f:
        _szip_dataset(f, "narrow", _signal("<u2", (30, 5), 1), (10, 5), nn,
                      8)
        _szip_dataset(f, "wide", _signal("|u1", (3, 3000), 2), (2, 3000),
                      nn, 8)
        _szip_dataset(f, "odd", _signal(">i2", (4, 7, 23), 3), (3, 7, 23),
                      ec, 16)
        p24 = h5py.h5t.STD_U32LE.copy()
        p24.set_precision(24)
        data = (_signal("<u4", (6, 40), 4) * 997) % (1 << 24)
        _szip_dataset(f, "p24", data.astype("<u4"), (3, 40), nn, 16, p24)
    _same_file(path)
    with h5py.File(path) as f:
        assert f["wide"].id.get_create_plist().get_filter(0)[2][3] == 1024
        assert f["p24"].id.get_create_plist().get_filter(0)[2][2] == 24


def test_szip_raw_chunk_and_corrupt_stream(tmp_path):
    """A chunk the optional filter could not code in fewer bytes (noise)
    is stored raw, its mask bit set; a corrupt stream raises HDF5Error."""
    path = str(tmp_path / "f.h5")
    noise = np.random.default_rng(5).integers(0, 256, 256, dtype=np.uint8)
    with h5py.File(path, "w") as f:
        f.create_dataset("noise", data=noise, chunks=(128,),
                         compression="szip", compression_opts=("nn", 8))
        f.create_dataset("x", data=_signal("<i2", (64,), 5), chunks=(64,),
                         compression="szip", compression_opts=("nn", 32))
    _same_file(path)
    with h5py.File(path) as f:
        assert f["noise"].id.read_direct_chunk((0,))[0] != 0
        mask, raw = f["x"].id.read_direct_chunk((0,))
        offset = f["x"].id.get_chunk_info(0).byte_offset
    assert mask == 0
    data = bytearray(open(path, "rb").read())
    data[offset + 4:offset + len(raw)] = b"\xff" * (len(raw) - 4)
    open(path, "wb").write(bytes(data))
    with hdf5.File(path) as g, pytest.raises(hdf5.HDF5Error,
                                             match="szip"):
        g["x"][()]


# -- n-bit --------------------------------------------------------------------


def nbit_plain(data: bytes, n: int, size: int, big_endian: bool,
               precision: int, offset: int) -> bytes:
    """The n-bit filter's decoding, one bit at a time."""
    bits = np.unpackbits(np.frombuffer(data, np.uint8))[:n * precision]
    out = bytearray()
    for i in range(n):
        v = int("".join(map(str, bits[i * precision:(i + 1) * precision])),
                2) << offset
        out += v.to_bytes(size, "big" if big_endian else "little")
    return bytes(out)


NBIT_CASES = [("<u1", 5, 2), ("|i1", 6, 1), ("<u2", 12, 4), (">u2", 9, 0),
              ("<i2", 10, 3), (">i2", 16, 0), ("<u4", 20, 7), (">i4", 27, 5),
              ("<i8", 40, 11), (">u8", 64, 0), ("<i8", 57, 2)]


@pytest.mark.parametrize("dtype,precision,offset", NBIT_CASES)
def test_nbit_reads_equal(tmp_path, dtype, precision, offset):
    dt = np.dtype(dtype)
    rng = np.random.default_rng(precision)
    lo = -(1 << (precision - 1)) if dt.kind == "i" else 0
    hi = (1 << (precision - 1)) - 1 if dt.kind == "i" else (
        1 << precision) - 1
    data = rng.integers(lo, hi, (5, 6, 7), endpoint=True,
                        dtype=np.int64 if dt.kind == "i" or precision < 64
                        else np.uint64).astype(dt)
    tid = h5py.h5t.py_create(dt).copy()
    tid.set_precision(precision)
    tid.set_offset(offset)
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        for name, deflate in (("nbit", False), ("nbit_deflate", True)):
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_chunk((2, 4, 7))
            dcpl.set_filter(h5py.h5z.FILTER_NBIT)
            if deflate:
                dcpl.set_deflate(4)
            h5py.h5d.create(f.id, name.encode(), tid,
                            h5py.h5s.create_simple(data.shape),
                            dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL,
                                             data)
        # the same type without the filter: the conversion alone
        h5py.h5d.create(f.id, b"plain", tid, h5py.h5s.create_simple(
            data.shape)).write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    _same_file(path)
    with h5py.File(path) as f:
        _check_equal(f["nbit"][()], data)  # h5py gives back what it wrote
        mask, raw = f["nbit"].id.read_direct_chunk((0, 0, 0))
    n = 2 * 4 * 7
    got = hdf5._nbit(raw, (8, 0, n, 1, dt.itemsize,
                           int(dt.byteorder == ">"), precision, offset))
    assert got == nbit_plain(raw, n, dt.itemsize, dt.byteorder == ">",
                             precision, offset)


def test_nbit_reduced_float_and_short_chunk(tmp_path):
    """HDF5's n-bit example float (20 bits at bit 7: a 6-bit exponent, a
    13-bit mantissa) reads as h5py's float32; a chunk short of its bits
    raises."""
    script = _fixture_script()
    path = str(tmp_path / "f.h5")
    data = np.concatenate([np.random.default_rng(0).standard_normal(60) * 50,
                           [0.0, -0.0, 1.5, 2.0 ** -40, -3e-9, 1e9]]
                          ).astype("<f4")
    with h5py.File(path, "w") as f:
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((11,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        h5py.h5d.create(f.id, b"x", script.reduced_float_type(h5py),
                        h5py.h5s.create_simple(data.shape),
                        dcpl=dcpl).write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    _same_file(path)
    with h5py.File(path) as f:
        assert f["x"].dtype == np.dtype("<f4")
    with pytest.raises(hdf5.HDF5Error, match="corrupt"):
        hdf5._nbit(b"\0" * 3, (8, 0, 2, 1, 4, 0, 20, 7))


@pytest.mark.parametrize("fields,ebias,size", [
    ((14, 9, 5, 0, 9), 53, 2),    # h5py: float32 (the bias)
    ((15, 10, 5, 0, 10), 15, 2),  # float16
    ((15, 10, 5, 0, 10), 15, 4),  # float32 (never narrower than the type)
    ((31, 23, 8, 0, 23), 100, 4),  # float64 (the exponent range)
    ((30, 22, 8, 0, 22), 127, 4)])
def test_custom_floats_read_as_h5py_picks(tmp_path, fields, ebias, size):
    base = h5py.h5t.IEEE_F32LE if size == 4 else h5py.h5t.IEEE_F16LE
    tid = base.copy()
    tid.set_fields(*fields)
    tid.set_ebias(ebias)
    data = np.array([0.0, 1.0, -2.5, 3.75, 0.125, -1024.0, 6e-5],
                    "<f8")
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        h5py.h5d.create(f.id, b"x", tid, h5py.h5s.create_simple(
            data.shape)).write(h5py.h5s.ALL, h5py.h5s.ALL, data)
    _same_file(path)


# -- virtual datasets ---------------------------------------------------------


def _sources(d, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(-100, 100, (6, 10, 12)).astype("<i4")
    with h5py.File(os.path.join(d, "src_a.h5"), "w") as f:
        f.create_dataset("x", data=a, chunks=(2, 5, 6), compression="gzip")
    os.makedirs(os.path.join(d, "sub"), exist_ok=True)
    with h5py.File(os.path.join(d, "sub", "src_b.h5"), "w") as f:
        f.create_dataset("y/z", data=a[::-1] * 3)
    return a


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_vds_selections_read_equal_from_another_directory(tmp_path,
                                                          monkeypatch,
                                                          libver):
    """Strided, offset and overlapping mappings, sources beside the file,
    in a subdirectory and "." (superblock 0 writes version-1 block lists,
    latest version-3 hyperslabs); read from another directory, whole and
    by random regions."""
    d = tmp_path / "data"
    d.mkdir()
    a = _sources(str(d))
    path = str(d / "v.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("own", data=np.arange(40, dtype="<i2").reshape(4, 10))
        lay = h5py.VirtualLayout(shape=(8, 10, 20), dtype="<i8")
        src_a = h5py.VirtualSource("src_a.h5", "x", shape=a.shape)
        src_b = h5py.VirtualSource("sub/src_b.h5", "/y/z", shape=a.shape)
        own = h5py.VirtualSource(".", "own", shape=(4, 10))
        lay[0:6, :, 0:12] = src_a
        lay[0:3, ::2, 12:20:2] = src_b[1:6:2, 0:10:2, 4:8]
        lay[6, 2:6, 1:11] = own
        lay[2:4, 1:3, 5:9] = src_b[0:2, 0:2, 0:4]  # over the first mapping
        f.create_virtual_dataset("v", lay, fillvalue=-7)
    monkeypatch.chdir(tmp_path)
    _same_file(path)
    rng = np.random.default_rng(1)
    with h5py.File(path) as f, hdf5.File(path) as g:
        for _ in range(20):
            lo = [int(rng.integers(0, n)) for n in (8, 10, 20)]
            hi = [int(rng.integers(l + 1, n + 1)) for l, n in zip(
                lo, (8, 10, 20))]
            idx = tuple(slice(l, h) for l, h in zip(lo, hi))
            _check_equal(g["v"][idx], f["v"][idx])
        _check_equal(g["v"][3, 1:9:3, ::5], f["v"][3, 1:9:3, ::5])
        assert g["v"].chunks is None and g["v"].compression is None


def _blocks(f, name, vshape, vsel, src, sshape, ssel, fill):
    _fixture_script()._virtual_blocks(h5py, f, name, vshape, vsel, src, "x",
                                      sshape, ssel, fill)


def test_vds_blocked_selections_and_reshaped_mappings(tmp_path):
    """Hyperslabs of blocks (start, count, stride, block) on both sides,
    and mappings whose two selections differ in shape (element i of one
    is element i of the other)."""
    a = _sources(str(tmp_path))
    path = str(tmp_path / "v.h5")
    with h5py.File(path, "w", libver="latest") as f:
        _blocks(f, "blocks", (6, 12, 12), ((0, 1, 0), (1, 3, 4), (1, 4, 3),
                                           (6, 2, 2)),
                "src_a.h5", a.shape, ((0, 0, 0), (1, 3, 4), (1, 3, 3),
                                      (6, 2, 2)), np.int32(3))
        _blocks(f, "reshaped", (12, 30), ((0, 0), (1, 1), (1, 1), (12, 30)),
                "src_a.h5", a.shape, ((0, 0, 0), (1, 1, 1), (1, 1, 1),
                                      (3, 10, 12)), np.int32(0))
    with h5py.File(path, "w", libver="earliest") as f:
        _blocks(f, "blocks", (6, 12, 12), ((0, 1, 0), (1, 3, 4), (1, 4, 3),
                                           (6, 2, 2)),
                "src_a.h5", a.shape, ((0, 0, 0), (1, 3, 4), (1, 3, 3),
                                      (6, 2, 2)), np.int32(3))
    _same_file(path)
    with h5py.File(path, "r+", libver="latest") as f:
        _blocks(f, "reshaped", (12, 30), ((0, 0), (1, 1), (1, 1), (12, 30)),
                "src_a.h5", a.shape, ((0, 0, 0), (1, 1, 1), (1, 1, 1),
                                      (3, 10, 12)), np.int32(0))
    _same_file(path)
    with h5py.File(path) as f, hdf5.File(path) as g:
        _check_equal(g["reshaped"][5:9, 3:25], f["reshaped"][5:9, 3:25])


def test_vds_missing_sources_read_the_fill_value(tmp_path, monkeypatch):
    """A source file that is gone and a source dataset that is not in its
    file read as the fill value, as the library reads them; the mapping
    that opens still reads, and a source that appears later is read."""
    a = _sources(str(tmp_path))
    path = str(tmp_path / "v.h5")
    with h5py.File(path, "w") as f:
        lay = h5py.VirtualLayout(shape=(3, 6, 10, 12), dtype="<f4")
        lay[0] = h5py.VirtualSource("src_a.h5", "x", shape=a.shape)
        lay[1] = h5py.VirtualSource("later.h5", "x", shape=a.shape)
        lay[2] = h5py.VirtualSource("src_a.h5", "nope", shape=a.shape)
        f.create_virtual_dataset("v", lay, fillvalue=-1.25)
    monkeypatch.chdir(tmp_path / "sub")
    _same_file(path)
    with hdf5.File(path) as g:
        got = g["v"][()]
        assert (got[1:] == np.float32(-1.25)).all()
        shutil.copy(tmp_path / "src_a.h5", tmp_path / "later.h5")
        _check_equal(g["v"][1], a.astype("<f4"))


def test_vds_percent_names_and_refusals(tmp_path):
    """"%%" in a source name is a literal "%"; unlimited and printf-named
    mappings raise HDF5Error naming ROADMAP item 20."""
    a = _sources(str(tmp_path))
    shutil.copy(tmp_path / "src_a.h5", tmp_path / "src_%a.h5")
    path = str(tmp_path / "v.h5")
    with h5py.File(path, "w") as f:
        lay = h5py.VirtualLayout(shape=a.shape, dtype="<i4")
        lay[:] = h5py.VirtualSource("src_%%a.h5", "x", shape=a.shape)
        f.create_virtual_dataset("pct", lay)
        lay = h5py.VirtualLayout(shape=(2, 12), maxshape=(2, None),
                                 dtype="<i4")
        src = h5py.VirtualSource("src_a.h5", "x", shape=(12,),
                                 maxshape=(None,))
        lay[0, :h5py.h5s.UNLIMITED] = src[:h5py.h5s.UNLIMITED]
        f.create_virtual_dataset("unlimited", lay)
        # one source file a block: src_0.h5, src_1.h5, ...
        vspace = h5py.h5s.create_simple((3, 12), (h5py.h5s.UNLIMITED, 12))
        vspace.select_hyperslab((0, 0), (h5py.h5s.UNLIMITED, 1),
                                block=(1, 12))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_virtual(vspace, b"src_%b.h5", b"x",
                         h5py.h5s.create_simple((12,)))
        h5py.h5d.create(f.id, b"printf", h5py.h5t.STD_I32LE,
                        h5py.h5s.create_simple((3, 12), (
                            h5py.h5s.UNLIMITED, 12)), dcpl=dcpl)
    with h5py.File(path) as f, hdf5.File(path) as g:
        assert g.keys() == ["pct", "printf", "unlimited"]
        _check_equal(g["pct"][()], f["pct"][()])
        for name, what in (("unlimited", "unlimited"),
                           ("printf", "printf-named")):
            with pytest.raises(hdf5.HDF5Error, match=what) as err:
                g[name]
            assert HDF5_ITEM in str(err.value)
            assert "virtual dataset" in str(err.value)


# -- external links -----------------------------------------------------------


def _link_files(d):
    a = np.arange(24, dtype=">f8").reshape(4, 6)
    with h5py.File(os.path.join(d, "target.h5"), "w") as f:
        f.create_dataset("grp/x", data=a, chunks=(2, 3), compression="gzip")
        f["grp/soft"] = h5py.SoftLink("/grp/x")
        f["back"] = h5py.ExternalLink("links.h5", "/local")
    with h5py.File(os.path.join(d, "links.h5"), "w", libver="latest") as f:
        f.create_dataset("local", data=np.arange(3, dtype="<u2"))
        f["rel"] = h5py.ExternalLink("target.h5", "/grp/x")
        f["abs"] = h5py.ExternalLink(os.path.join(d, "target.h5"), "grp")
        f["gone_dir"] = h5py.ExternalLink("/no/such/dir/target.h5",
                                          "/grp/soft")
        f["round_trip"] = h5py.ExternalLink("target.h5", "/back")
        f["soft_ext"] = h5py.SoftLink("/rel")
        f["dangling"] = h5py.ExternalLink("missing.h5", "/x")
        f["dangling_obj"] = h5py.ExternalLink("target.h5", "/nope")
        f["cycle"] = h5py.ExternalLink("links.h5", "/cycle")
    return a


def test_external_links_resolve_as_h5py_does(tmp_path, monkeypatch):
    d = tmp_path / "d"
    d.mkdir()
    a = _link_files(str(d))
    path = str(d / "links.h5")
    monkeypatch.chdir(tmp_path)
    with h5py.File(path) as f, hdf5.File(path) as g:
        assert g.keys() == list(f.keys())
        for name in ("rel", "abs/x", "abs/soft", "gone_dir", "round_trip",
                     "soft_ext"):
            _check_equal(g[name][()], f[name][()])
        assert g["abs"].keys() == list(f["abs"].keys())
        _check_equal(g["rel"][1:3, ::2], a[1:3, ::2])
        for name in ("dangling", "dangling_obj", "cycle", "dangling/x",
                     "rel/x", "local/x"):
            with pytest.raises(KeyError):
                f[name]
            with pytest.raises(KeyError):
                g[name]
            assert (name in g) == (name in f), name
        for name in ("rel", "abs/x", "/abs/soft", "abs", "nothing"):
            assert (name in g) == (name in f), name
        opened = list(g._store.opened.values())
        assert opened and all(o._store.fd is not None for o in opened)
    # the targets close with the file that opened them
    assert all(o._store.fd is None for o in opened)


def test_no_dataset_is_made_through_an_external_link(tmp_path):
    """``create_dataset`` in "r+" makes datasets in the file it opened: a
    path through an external link raises, and neither file changes."""
    d = tmp_path / "d"
    d.mkdir()
    _link_files(str(d))
    path = str(d / "links.h5")
    sizes = [os.path.getsize(d / n) for n in ("links.h5", "target.h5")]
    with hdf5.File(path, "r+") as g:
        with pytest.raises(ValueError, match="another file"):
            g.create_dataset("abs/new", data=np.arange(3))
    assert [os.path.getsize(d / n) for n in ("links.h5", "target.h5")] == (
        sizes)
    _same_file(path)


def test_external_link_prefixes(tmp_path, monkeypatch):
    """``HDF5_EXT_PREFIX`` (":"-separated, ``${ORIGIN}`` the linking file's
    directory) comes before the linking file's directory."""
    d = tmp_path / "d"
    (d / "elsewhere").mkdir(parents=True)
    with h5py.File(str(d / "elsewhere" / "t.h5"), "w") as f:
        f["x"] = np.arange(4)
    with h5py.File(str(d / "t.h5"), "w") as f:
        f["x"] = np.arange(4) * 10
    with h5py.File(str(d / "links.h5"), "w") as f:
        f["l"] = h5py.ExternalLink("t.h5", "/x")
    monkeypatch.chdir(tmp_path)
    for prefix, want in (("", 10), ("/no/where:${ORIGIN}/elsewhere", 1),
                         (str(d / "elsewhere"), 1)):
        monkeypatch.setenv("HDF5_EXT_PREFIX", prefix)
        with hdf5.File(str(d / "links.h5")) as g:
            _check_equal(g["l"][()], np.arange(4) * want)


def test_lazy_memo_appends_beside_an_external_link(tmp_path):
    """The Lazy path's "r+" memo append rewrites the root group's header;
    its external links (one to a file that exists, one dangling) keep
    their stored bytes, and h5py reads raw, the memo and both links."""
    from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_data
    from mdeical_image_segmentation_tpu_torch.data.volume_utils import (
        mirror_pad,
    )

    for libver in ("earliest", "latest"):
        path = str(tmp_path / f"vol_{libver}.h5")
        raw = np.random.default_rng(3).integers(0, 255, (8, 32, 32),
                                                dtype=np.uint8)
        with h5py.File(str(tmp_path / "meta.h5"), "w") as f:
            f["info"] = np.arange(5)
        with h5py.File(path, "w", libver=libver) as f:
            f.create_dataset("raw", data=raw, chunks=(4, 16, 16),
                             compression="gzip")
            f["meta"] = h5py.ExternalLink("meta.h5", "/info")
            f["gone"] = h5py.ExternalLink("gone.h5", "/nothing")
        ds = port_data.LazyHDF5Dataset(
            file_path=path, phase="test", slice_builder_config=dict(
                INTEROP_SLICES), transformer_config=INTEROP_TRANSFORMS)
        ds[0]
        memo = "raw_padded_1x2x2"
        with h5py.File(path) as f:
            assert list(f.keys()) == ["gone", "meta", "raw", memo]
            _check_equal(f[memo][()], mirror_pad(raw, (1, 2, 2)))
            _check_equal(f["raw"][()], raw)
            _check_equal(f["meta"][()], np.arange(5))
            for name, file, obj in (("meta", "meta.h5", "/info"),
                                    ("gone", "gone.h5", "/nothing")):
                link = f.get(name, getlink=True)
                assert (link.filename, link.path) == (file, obj)
        _same_file(path)


# -- external raw storage -----------------------------------------------------


def test_external_storage_resolves_as_h5py_does(tmp_path, monkeypatch):
    """Relative raw file names start at the working directory (not the
    file's): from there both read equal; from elsewhere both raise
    OSError; ``HDF5_EXTFILE_PREFIX`` points the port at them; a raw file
    shorter than its segment reads zeros past its end."""
    d = tmp_path / "d"
    d.mkdir()
    a = np.random.default_rng(4).integers(-999, 999, (5, 7, 9)).astype(">i4")
    monkeypatch.chdir(d)
    with h5py.File("e.h5", "w") as f:
        f.create_dataset("x", data=a, external=[
            ("seg_a.bin", 3, 100), ("seg_b.bin", 0, 60),
            ("seg_c.bin", 17, a.nbytes - 160)])
        f.create_dataset("short", data=a[0], external=[("seg_d.bin", 0,
                                                        a[0].nbytes)])
    with open("seg_d.bin", "r+b") as raw:
        raw.truncate(50)
    _same_file("e.h5")
    with h5py.File("e.h5") as f, hdf5.File("e.h5") as g:
        _check_equal(g["x"][1:4, 2:5, ::3], f["x"][1:4, 2:5, ::3])
        assert f["short"][()].ravel()[13:].max() == 0
    monkeypatch.chdir(tmp_path)
    with h5py.File(str(d / "e.h5")) as f, pytest.raises(OSError):
        f["x"][()]
    with hdf5.File(str(d / "e.h5")) as g:
        with pytest.raises(OSError, match="external raw data file"):
            g["x"][()]
        monkeypatch.setenv("HDF5_EXTFILE_PREFIX", "${ORIGIN}")
        _check_equal(g["x"][()], a)
        monkeypatch.setenv("HDF5_EXTFILE_PREFIX", str(d))
        _check_equal(g["x"][2], a[2])


# -- committed datatypes and unused bits --------------------------------------


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_committed_datatypes_read_equal(tmp_path, libver):
    path = str(tmp_path / "f.h5")
    rng = np.random.default_rng(5)
    with h5py.File(path, "w", libver=libver) as f:
        for dt in ("<f4", ">f8", "<i2", ">u4", "|u1"):
            name = f"t_{dt[1:]}_{'be' if dt[0] == '>' else 'le'}"
            f[name] = np.dtype(dt)
            data = (rng.standard_normal((4, 5)) * 100).astype(dt)
            f.create_dataset(f"c_{name}", data=data, dtype=f[name])
            f.create_dataset(f"k_{name}", data=data, dtype=f[name],
                             chunks=(2, 5), compression="gzip")
    _same_file(path)
    with h5py.File(path) as f, hdf5.File(path) as g:
        for k in f:
            if isinstance(f[k], h5py.Datatype):
                assert isinstance(g[k], hdf5.Datatype)
                assert g[k].dtype == f[k].dtype


def test_multi_linked_group_append_is_still_refused(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest") as f:
        g = f.create_group("g")
        g["x"] = np.arange(3)
        f["also_g"] = g
    f = hdf5.File(path, "r+")
    f.create_dataset("g/new", data=np.arange(2))
    with pytest.raises(hdf5.HDF5Error, match="more than one hard link") as e:
        f.close()
    assert HDF5_ITEM in str(e.value)


# -- the JAX package's datasets (h5py) against the port's ---------------------

INTEROP_SLICES = {"name": "SliceBuilder", "patch_shape": [4, 16, 16],
                  "stride_shape": [4, 16, 16], "halo_shape": [1, 2, 2],
                  "skip_shape_check": True}
INTEROP_TRANSFORMS = {"raw": [{"name": "Standardize"},
                              {"name": "ToTensor", "expand_dims": True}],
                      "label": [{"name": "ToTensor", "expand_dims": True}]}


def _volume_files(d):
    """One (8, 32, 32) volume with its label as a VDS over two files, as an
    external link and with szip."""
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 255, (8, 32, 32), dtype=np.uint8)
    label = (raw > 128).astype("<i8")
    for part, sl in (("a", slice(0, 4)), ("b", slice(4, 8))):
        with h5py.File(os.path.join(d, f"half_{part}.h5"), "w") as f:
            f.create_dataset("raw", data=raw[sl], chunks=(2, 16, 16),
                             compression="gzip")
            f.create_dataset("label", data=label[sl])
    with h5py.File(os.path.join(d, "vds.h5"), "w", libver="latest") as f:
        for name, dt in (("raw", raw.dtype), ("label", label.dtype)):
            lay = h5py.VirtualLayout(shape=raw.shape, dtype=dt)
            lay[0:4] = h5py.VirtualSource("half_a.h5", name, shape=(4, 32,
                                                                    32))
            lay[4:8] = h5py.VirtualSource("half_b.h5", name, shape=(4, 32,
                                                                    32))
            f.create_virtual_dataset(name, lay)
    with h5py.File(os.path.join(d, "whole.h5"), "w") as f:
        f.create_dataset("raw", data=raw)
        f.create_dataset("label", data=label)
    with h5py.File(os.path.join(d, "ext.h5"), "w") as f:
        f["raw"] = h5py.ExternalLink("whole.h5", "/raw")
        f["label"] = h5py.ExternalLink("whole.h5", "/label")
    with h5py.File(os.path.join(d, "szip.h5"), "w") as f:
        f.create_dataset("raw", data=raw, chunks=(4, 16, 32),
                         compression="szip", compression_opts=("nn", 8))
        f.create_dataset("label", data=label, chunks=(4, 16, 32),
                         compression="szip", compression_opts=("ec", 16))
    return raw


def _patches(ds):
    return [ds[i] for i in range(len(ds))]


def _same_patches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for u, v in zip(a, b):
            if isinstance(v, np.ndarray):
                _check_equal(u, v)
            else:
                assert u == v


@pytest.fixture(scope="module")
def volumes(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("item20_volumes"))
    _volume_files(d)
    return d


@pytest.mark.parametrize("name", ["vds.h5", "ext.h5", "szip.h5"])
@pytest.mark.parametrize("phase", ["test", "val"])
def test_standard_dataset_gives_jax_patches(volumes, name, phase):
    from mdeical_image_segmentation_tpu.data import hdf5 as jax_data
    from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_data

    kw = dict(file_path=os.path.join(volumes, name), phase=phase,
              slice_builder_config=dict(INTEROP_SLICES),
              transformer_config=INTEROP_TRANSFORMS)
    _same_patches(_patches(port_data.StandardHDF5Dataset(**kw)),
                  _patches(jax_data.StandardHDF5Dataset(**kw)))


@pytest.mark.parametrize("name", ["vds.h5", "ext.h5", "szip.h5"])
def test_lazy_memo_equal_in_both_packages(volumes, tmp_path, name):
    """Each package's LazyHDF5Dataset on its own copy (h5py's "r+" for the
    JAX package, the port's for the port): equal patches, and the memo
    each appended reads the same in h5py and in the port."""
    from mdeical_image_segmentation_tpu.data import hdf5 as jax_data
    from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_data

    memos, patches = [], []
    for tag, module in (("jax", jax_data), ("port", port_data)):
        d = tmp_path / tag
        shutil.copytree(volumes, d)
        path = str(d / name)
        ds = module.LazyHDF5Dataset(
            file_path=path, phase="test",
            slice_builder_config=dict(INTEROP_SLICES),
            transformer_config=INTEROP_TRANSFORMS)
        patches.append(_patches(ds))
        with h5py.File(path) as f, hdf5.File(path) as g:
            memo = f["raw_padded_1x2x2"][()]
            _check_equal(g["raw_padded_1x2x2"][()], memo)
            _check_equal(g["raw"][()], f["raw"][()])
        memos.append(memo)
        _same_file(path)
    _same_patches(patches[1], patches[0])
    _check_equal(memos[1], memos[0])


@pytest.mark.parametrize("name", ["vds.h5", "ext.h5", "szip.h5"])
def test_device_cache_loads_the_volumes(volumes, name):
    """``data/device_cache.py`` reads a training volume and its label
    whole through the same reader (what ``cli/train3d.py`` with
    ``device_cache`` loads onto the card)."""
    from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_data
    from mdeical_image_segmentation_tpu_torch.data.device_cache import (
        DeviceCachedVolumeLoader,
    )

    path = os.path.join(volumes, name)
    ds = port_data.StandardHDF5Dataset(
        file_path=path, phase="train",
        slice_builder_config=dict(INTEROP_SLICES),
        transformer_config=INTEROP_TRANSFORMS)
    raw, label = DeviceCachedVolumeLoader._load_volume(ds, [])
    with h5py.File(path) as f:
        _check_equal(raw[..., 0], f["raw"][()].astype(np.float32))
        _check_equal(label[..., 0], f["label"][()])
