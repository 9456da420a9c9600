"""The port's HDF5 codec (``utils/hdf5.py``) on every file h5py writes for
the 3D pipeline, against h5py, exactly: values, shapes, dtypes, names.

- libver default, "v108", "v110" and "latest" (superblocks 0, 2 and 3,
  version-2 object headers) with every layout: contiguous, compact, and in
  layout 4 every chunk index (single chunk plain and filtered, implicit,
  fixed array plain, filtered and paged, extensible array plain, filtered,
  sparse, on a middle axis and past its index block, version-2 B-tree
  plain and filtered, deep enough for internal nodes); windowed reads.
- the filters h5py has built in: gzip + shuffle, LZF, Fletcher-32, and
  scale-offset in integer and D-scale float modes, alone and stacked; the
  C LZF decoder equal to the plain one on h5py's own chunks.
- bool, float16 (both byte orders), an integer enum and the 20 integer
  and float types in a latest file.
- groups: compact and dense link storage, ``track_order``, nested, soft
  links (relative, absolute, into and out of symbol-table groups).
- ``"r+"`` appends on each group form (a latest root, compact and dense; a
  default file's ``track_order`` root; a compact subgroup; a dense
  subgroup; a ``track_order`` subgroup under a symbol-table root): h5py
  then reads every dataset equal and appends again, and the port reads
  that.
- external links, szip, n-bit and virtual datasets read as h5py reads
  them; the refusals: compound and string types and a bad checksum raise
  ``HDF5Error`` naming what they are."""

import os

import h5py
import numpy as np
import pytest

from mdeical_image_segmentation_tpu_torch.utils import hdf5

LIBVERS = ["earliest", "v108", "v110", "latest"]
DTYPES = [f"{o}{k}{n}" for o in "<>" for k, n in
          [("u", 1), ("u", 2), ("u", 4), ("u", 8), ("i", 1), ("i", 2),
           ("i", 4), ("i", 8), ("f", 4), ("f", 8)]]


def _data(dtype, shape=(5, 7, 9), seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "b":
        return rng.random(shape) > 0.5
    if dt.kind == "f":
        a = rng.standard_normal(shape) * (10 if dt.itemsize == 2 else 1e3)
    else:
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, size=shape, endpoint=True,
                         dtype=dt.newbyteorder("="))
    return np.asarray(a, dtype=dt)


def _check_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _compare_files(path):
    """Every dataset of the file, walked from the root in h5py's order,
    reads equal in the port; the names too."""
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        def walk(a, b):
            assert list(a.keys()) == b.keys(), a.name
            for k in a.keys():
                if isinstance(a[k], h5py.Group):
                    walk(a[k], b[k])
                else:
                    want, ds = a[k], b[k]
                    assert (ds.shape, ds.dtype, ds.chunks) == (
                        want.shape, want.dtype, want.chunks), k
                    assert ds.compression == want.compression, k
                    _check_equal(ds[()], want[()])
        walk(f, g)


def _early():
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _compact(f, name, data):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    space = h5py.h5s.create_simple(data.shape)
    tid = h5py.h5t.py_create(data.dtype)
    h5py.h5d.create(f.id, name.encode(), tid, space, dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, data)


def _layout(f, layout):
    """One dataset ``x`` of the layout (and chunk index) asked for."""
    a = _data("<i2")
    kw = {
        "contiguous": {},
        "chunked": {"chunks": (2, 3, 4)},
        "single": {"chunks": a.shape},
        "single_gzip": {"chunks": a.shape, "compression": "gzip"},
        "implicit": {"chunks": (2, 3, 4), "dcpl": _early()},
        "implicit_maxshape": {"chunks": (2, 3, 4), "dcpl": _early(),
                              "maxshape": (8, 7, 12)},
        "farray_gzip": {"chunks": (2, 3, 4), "compression": "gzip",
                        "shuffle": True},
        "earray": {"chunks": (2, 3, 4), "maxshape": (None, 7, 9)},
        "earray_gzip": {"chunks": (2, 3, 4), "maxshape": (None, 7, 9),
                        "compression": "gzip"},
        "earray_middle": {"chunks": (2, 3, 4), "maxshape": (5, None, 9)},
        "bt2": {"chunks": (2, 3, 4), "maxshape": (None, None, 9)},
        "bt2_gzip": {"chunks": (2, 3, 4), "maxshape": (None, 9, None),
                     "compression": "gzip"},
    }
    if layout == "compact":
        _compact(f, "x", a)
    elif layout == "farray_paged":  # 1200 chunks > 1024: paged, 2 written
        ds = f.create_dataset("x", shape=(40, 60), dtype="<u2",
                              chunks=(1, 2), fillvalue=3)
        ds[0:2, 0:4] = np.arange(8).reshape(2, 4)
        ds[39, 50:60] = 9
    elif layout == "earray_deep":  # 300 chunks: past the index block
        f.create_dataset("x", data=np.arange(1200, dtype="<i4").reshape(
            300, 4), chunks=(1, 4), maxshape=(None, 4))
    elif layout == "bt2_deep":  # 200 chunks: a tree with internal nodes
        f.create_dataset("x", data=np.arange(800, dtype="<f8").reshape(
            50, 16), chunks=(1, 4), maxshape=(None, None),
            compression="gzip")
    else:
        f.create_dataset("x", data=a, **kw[layout])


LAYOUTS_LATEST = ["contiguous", "compact", "chunked", "single", "single_gzip",
                  "implicit", "implicit_maxshape", "farray_gzip",
                  "farray_paged", "earray", "earray_gzip", "earray_middle",
                  "earray_deep", "bt2", "bt2_gzip", "bt2_deep"]
CASES = ([("earliest", lay) for lay in ("contiguous", "compact", "chunked",
                                          "earray", "bt2")]
         + [(lv, lay) for lv in ("v108", "v110") for lay in (
             "chunked", "single", "implicit", "earray", "bt2")]
         + [("latest", lay) for lay in LAYOUTS_LATEST])


@pytest.mark.parametrize("libver,layout", CASES)
def test_layouts_and_chunk_indexes_read_equal(tmp_path, libver, layout):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        _layout(f, layout)
    _compare_files(path)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        want, ds = f["x"], g["x"]
        for index in [(slice(1, 4), slice(2, None), slice(0, 9, 2)),
                      (3,), (Ellipsis, 1), (slice(None), -1)]:
            index = index[:ds.ndim]
            _check_equal(ds[index], want[index])


def test_sparse_extensible_array_reads_the_fill_value(tmp_path):
    """Chunks never written read as the fill value, in the index block and
    past it."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest") as f:
        ds = f.create_dataset("x", shape=(400, 6), dtype="<i2",
                              chunks=(2, 3), maxshape=(None, 6),
                              fillvalue=-7, compression="lzf")
        ds[0:2, 3:6] = 1
        ds[57, :] = np.arange(6)
        ds[399, 0] = 5
    _compare_files(path)
    with hdf5.File(path) as g:
        assert (g["x"][100:300] == -7).all()


FILTERS = {
    "gzip_shuffle": {"compression": "gzip", "compression_opts": 6,
                     "shuffle": True},
    "lzf": {"compression": "lzf"},
    "lzf_shuffle_fletcher": {"compression": "lzf", "shuffle": True,
                             "fletcher32": True},
    "fletcher32": {"fletcher32": True},
    "scaleoffset_int": {"scaleoffset": True},
    "scaleoffset_int_bits": {"scaleoffset": 5},
    "scaleoffset_float_2": {"scaleoffset": 2},
    "scaleoffset_float_4_gzip": {"scaleoffset": 4, "compression": "gzip"},
}


# scale-offset's integer mode takes integers, its D-scale mode floats
FILTER_CASES = [(name, dtype) for name in sorted(FILTERS)
                for dtype in ["<i2", ">i4", "<u1", "<f4", ">f8"]
                if not name.startswith("scaleoffset")
                or name.startswith("scaleoffset_float") == (dtype[1] == "f")]


@pytest.mark.parametrize("libver", ["earliest", "latest"])
@pytest.mark.parametrize("name,dtype", FILTER_CASES)
def test_filters_read_equal(tmp_path, libver, dtype, name):
    kw = FILTERS[name]
    is_float = np.dtype(dtype).kind == "f"
    rng = np.random.default_rng(len(name))
    data = (rng.standard_normal((6, 10, 11)) * 50 if is_float
            else rng.integers(0, 100, (6, 10, 11))).astype(dtype)
    data[0, 0, :3] = 0  # the fill value, which scale-offset codes apart
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        f.create_dataset("x", data=data, chunks=(2, 4, 5), **kw)
        f.create_dataset("y", data=data, chunks=(6, 10, 11),
                         maxshape=(None, 10, 11), **kw)
    _compare_files(path)


def test_lzf_c_decoder_equals_the_plain_one(tmp_path):
    """The chunks h5py's LZF filter wrote, decoded by csrc/lzf_decompress.c
    and by the plain Python loop: equal, and equal to the data; a buffer
    too small grows; a corrupt stream raises."""
    rng = np.random.default_rng(3)
    data = np.repeat(rng.integers(0, 9, (64, 1000), dtype=np.uint8), 3,
                     axis=1)
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=data, chunks=(8, 3000), compression="lzf")
    with h5py.File(path, "r") as f:
        ds = f["x"]
        for i in range(8):
            mask, raw = ds.id.read_direct_chunk((8 * i, 0))
            assert mask == 0 and len(raw) < data[8 * i:8 * i + 8].nbytes
            want = data[8 * i:8 * i + 8].tobytes()
            assert hdf5.lzf_decompress(raw, len(want)) == want
            assert lzf_decompress_plain(raw, len(want)) == want
            assert hdf5.lzf_decompress(raw, 10) == want  # grown
    with pytest.raises(hdf5.HDF5Error, match="corrupt LZF"):
        hdf5.lzf_decompress(b"\x05ab", 100)  # a literal run past the end
    with pytest.raises(hdf5.HDF5Error, match="corrupt LZF"):
        hdf5.lzf_decompress(b"\x00a\x20\x05", 100)  # a reference before 0


def lzf_decompress_plain(data: bytes, out_len: int) -> bytes:
    """The LZF format's loop in Python (liblzf's lzf_d.c)."""
    out, i = bytearray(), 0
    while i < len(data):
        ctrl = data[i]
        i += 1
        if ctrl < 32:
            out += data[i:i + ctrl + 1]
            i += ctrl + 1
        else:
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = len(out) - ((ctrl & 0x1F) << 8) - 1 - data[i]
            i += 1
            for k in range(length + 2):
                out.append(out[ref + k])
    assert len(out) <= out_len
    return bytes(out)


@pytest.mark.parametrize("dtype", DTYPES + ["|b1", "<f2", ">f2"])
@pytest.mark.parametrize("layout", ["contiguous", "chunked_gzip"])
def test_dtypes_read_equal_in_a_latest_file(tmp_path, dtype, layout):
    path = str(tmp_path / "f.h5")
    data = _data(dtype)
    kw = {} if layout == "contiguous" else {"chunks": (2, 3, 4),
                                            "compression": "gzip"}
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=data, **kw)
    with hdf5.File(path) as g:
        _check_equal(g["x"][:], data)
    _compare_files(path)


def test_enum_reads_as_its_base_type_and_bool_as_bool(tmp_path):
    path = str(tmp_path / "f.h5")
    colours = h5py.enum_dtype({"RED": 0, "GREEN": 1, "BLUE": 42},
                              basetype="<i2")
    with h5py.File(path, "w") as f:
        f.create_dataset("e", data=np.array([0, 42, 1], "<i2"),
                         dtype=colours)
        f.create_dataset("b", data=np.array([[True, False], [False, True]]))
        f.create_dataset("label", data=_data("<f4") > 0, chunks=(2, 3, 4),
                         compression="gzip")
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        for k in ("e", "b", "label"):
            _check_equal(g[k][:], f[k][:])
    with hdf5.File(path) as g:
        assert g["e"].dtype == np.dtype("<i2") and g["b"].dtype == bool


def _groups(f, dense: bool):
    n = 12 if dense else 3
    for i in range(n):
        f.create_dataset(f"d{(7 * i) % n:02d}", data=np.arange(i + 2))
    g = f.create_group("nested", track_order=True)
    for i in range(n):
        g.create_dataset(f"z{n - i:02d}", data=np.full(3, i))
    inner = g.create_group("inner")
    inner.create_dataset("deep", data=np.eye(3))
    f["soft_abs"] = h5py.SoftLink("/nested/inner/deep")
    g["soft_rel"] = h5py.SoftLink("inner")
    inner["up"] = h5py.SoftLink("/d01")


@pytest.mark.parametrize("libver", LIBVERS)
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("track_order", [False, True])
def test_groups_and_links_read_equal(tmp_path, libver, dense, track_order):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver, track_order=track_order) as f:
        _groups(f, dense)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert g.keys() == list(f.keys())
        assert g["nested"].keys() == list(f["nested"].keys())
        for k in ("soft_abs", "nested/soft_rel/deep", "nested/inner/up",
                  "nested/z01"):
            _check_equal(g[k][()], f[k][()])
        assert "soft_abs" in g and "nested/soft_rel/missing" not in g
    _compare_files(path)


@pytest.mark.parametrize("libver", ["earliest", "latest"])
def test_user_block_files_read_and_take_appends(tmp_path, libver):
    """h5py's ``userblock_size``: the superblock after 512 or 4096 bytes
    the user owns; every address counts from it."""
    for size in (512, 4096):
        path = str(tmp_path / f"u{size}.h5")
        with h5py.File(path, "w", libver=libver, userblock_size=size) as f:
            f.create_dataset("x", data=_data("<f4"), chunks=(2, 3, 4),
                             compression="gzip")
            f.create_dataset("y", data=_data("<i2"))
        with open(path, "r+b") as f:
            f.write(b"user data")
        _compare_files(path)
        with hdf5.File(path, "r+") as f:
            f.create_dataset("memo", data=np.arange(6.0), compression="gzip")
        _compare_files(path)
        with open(path, "rb") as f:
            assert f.read(9) == b"user data"


def test_superblock_extension_and_paged_file_space(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest", fs_strategy="page",
                   fs_page_size=4096) as f:
        f.create_dataset("x", data=_data("<f4"), chunks=(2, 3, 4),
                         compression="gzip")
    _compare_files(path)


def _old(i):
    return np.arange(i + 3, dtype="<i2") * (i + 1)


def _append_file(path, form):
    """A file h5py wrote; returns the group the port appends into."""
    libver = {"default": "earliest", "v108": "v108"}.get(
        form.split("_")[0], "latest")
    track = form in ("default_track_root", "latest_track_root")
    paged = ({"fs_strategy": "page", "fs_page_size": 4096}
             if form == "latest_paged_root" else {})
    with h5py.File(path, "w", libver=libver, track_order=track,
                   **paged) as f:
        n = 12 if "dense" in form else 3
        for i in range(n):
            f.create_dataset(f"d{i:02d}", data=_old(i),
                             chunks=(2,) if i % 2 else None,
                             compression="gzip" if i % 2 else None)
        if form == "latest_compact_sub":
            f.create_group("sub").create_dataset("a", data=_old(5))
            return "sub"
        if form == "latest_dense_sub":
            g = f.create_group("sub")
            for i in range(10):
                g.create_dataset(f"a{i}", data=_old(i))
            return "sub"
        if form == "default_track_sub":
            g = f.create_group("sub", track_order=True)
            g.create_dataset("a", data=_old(4))
            return "sub"
    return ""


FORMS = ["latest_compact_root", "latest_dense_root", "latest_track_root",
         "default_track_root", "latest_compact_sub", "latest_dense_sub",
         "default_track_sub", "latest_new_path", "latest_paged_root",
         "v108_dense_root"]


@pytest.mark.parametrize("form", FORMS)
def test_port_appends_to_link_groups_read_in_h5py(tmp_path, form):
    path = str(tmp_path / "f.h5")
    where = _append_file(path, form)
    if form == "latest_new_path":
        where = "made/on/the/way"
    name = f"{where}/raw_padded_1x2x2".lstrip("/")
    memo = _data("<f4", (4, 6, 8), seed=9)
    with hdf5.File(path, "r+") as f:
        f.create_dataset(name, data=memo, compression="gzip")
        assert name in f
    with h5py.File(path, "r") as f:
        _check_equal(f[name][()], memo)
        assert f[name].compression == "gzip"
    _compare_files(path)
    with h5py.File(path, "r+") as f:  # h5py appends after the port
        f.create_dataset(f"{where}/later".lstrip("/"), data=_old(9))
    with hdf5.File(path, "r+") as f:  # and the port again
        f.create_dataset(f"{where}/third".lstrip("/"), data=_old(2))
    with h5py.File(path, "r+") as f:
        f.create_dataset("fourth", data=_old(1))
    _compare_files(path)


def test_refusals_name_what_they_are(tmp_path):
    """What ROADMAP item 20 held until the external links, n-bit, szip and
    virtual datasets were read reads as h5py reads it; compound and string
    datasets still raise, naming the item."""
    path = str(tmp_path / "f.h5")
    with h5py.File(str(tmp_path / "other.h5"), "w") as f:
        f["x"] = np.arange(-2, 5, dtype="<i8")
    with h5py.File(str(tmp_path / "src.h5"), "w") as f:
        f["x"] = np.array([7, -8, 9], "<i4")
    with h5py.File(path, "w", libver="latest") as f:
        f["ext"] = h5py.ExternalLink("other.h5", "/x")
        f.create_dataset("compound", data=np.zeros(3, dtype=[("a", "<i4")]))
        f.create_dataset("string", data=np.array([b"ab", b"cde"]))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((4,))
        dcpl.set_filter(h5py.h5z.FILTER_NBIT)
        h5py.h5d.create(f.id, b"nbit", h5py.h5t.STD_I32LE,
                        h5py.h5s.create_simple((8,)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(-4, 4, dtype="<i4"))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_chunk((32,))
        dcpl.set_filter(h5py.h5z.FILTER_SZIP, h5py.h5z.FLAG_OPTIONAL,
                        (h5py.h5z.SZIP_NN_OPTION_MASK, 8))
        h5py.h5d.create(f.id, b"szip", h5py.h5t.STD_I32LE,
                        h5py.h5s.create_simple((64,)), dcpl=dcpl).write(
            h5py.h5s.ALL, h5py.h5s.ALL, np.arange(64, dtype="<i4") ** 2)
        layout = h5py.VirtualLayout(shape=(3,), dtype="<i4")
        layout[:] = h5py.VirtualSource("src.h5", "x", shape=(3,))
        f.create_virtual_dataset("vds", layout)
    with h5py.File(path) as f, hdf5.File(path) as g:
        assert g.keys() == ["compound", "ext", "nbit", "string", "szip",
                            "vds"]
        for name in ("ext", "nbit", "szip", "vds"):
            _check_equal(g[name][()], f[name][()])
        for name, what in [("compound", "compound"), ("string", "string")]:
            with pytest.raises(hdf5.HDF5Error, match=what) as err:
                g[name]
            assert "ROADMAP.md queue 1, item 20" in str(err.value)


def test_bad_checksums_raise(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=_data("<f4"), chunks=(2, 3, 4),
                         maxshape=(None, None, 9))
    raw = bytearray(open(path, "rb").read())
    for sig in (b"OHDR", b"BTHD", b"HDF\r"):
        bad = bytearray(raw)
        at = bad.index(sig) + 12
        bad[at] ^= 0x40
        bad_path = str(tmp_path / f"bad_{sig[:3].decode()}.h5")
        open(bad_path, "wb").write(bytes(bad))
        with pytest.raises(hdf5.HDF5Error, match="bad checksum"):
            with hdf5.File(bad_path) as g:
                g["x"][:]
    assert os.path.getsize(path) == len(raw)


@pytest.mark.parametrize("track_order", [False, True])
def test_large_dense_group_reads_and_takes_appends(tmp_path, track_order):
    """300 links: the fractal heap's root becomes an indirect block and
    the name index grows internal nodes; the port's append rewrites the
    group in compact form, which h5py reads and appends to."""
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver="latest", track_order=track_order) as f:
        for i in range(300):
            f.create_dataset(f"member_with_a_long_name_{(i * 37) % 300:03d}",
                             data=np.full(2, i, "<i2"))
    _compare_files(path)
    with hdf5.File(path, "r+") as f:
        f.create_dataset("memo", data=np.arange(5.0))
    _compare_files(path)
    with h5py.File(path, "r+") as f:
        f.create_dataset("after", data=np.arange(3))
        assert len(f) == 302
    _compare_files(path)


INTEROP_SLICES = {"name": "SliceBuilder", "patch_shape": [4, 16, 16],
                  "stride_shape": [4, 16, 16], "halo_shape": [1, 2, 2],
                  "skip_shape_check": True}
INTEROP_TRANSFORMS = {"raw": [{"name": "Standardize"},
                              {"name": "ToTensor", "expand_dims": True}],
                      "label": [{"name": "ToTensor", "expand_dims": True}]}


def _latest_volume(path):
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 255, (8, 32, 32), dtype=np.uint8)
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("raw", data=raw, chunks=(4, 16, 16),
                         maxshape=(None, None, 32), shuffle=True,
                         compression="gzip")
        f.create_dataset("label", data=raw > 128, chunks=(4, 16, 16),
                         maxshape=(None, 32, 32), compression="lzf")


def _patches(ds):
    return [ds[i] for i in range(len(ds))]


def _same_patches(ours, theirs):
    assert len(ours) == len(theirs) > 0
    for a, b in zip(ours, theirs):
        for u, v in zip(a, b):
            if isinstance(v, np.ndarray):
                assert u.dtype == v.dtype
                np.testing.assert_array_equal(u, v)
            else:
                assert u == v


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_lazy_memo_crosses_packages_on_a_latest_file(tmp_path, writer):
    """One package's LazyHDF5Dataset appends the raw_padded memo to a
    libver='latest' file (h5py for the JAX package, the port's "r+"), the
    other reads it; the patches equal the writer's, and h5py reads the
    appended file."""
    from mdeical_image_segmentation_tpu.data import hdf5 as jax_data
    from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_data

    path = str(tmp_path / "vol.h5")
    _latest_volume(path)
    kw = dict(phase="test", slice_builder_config=dict(INTEROP_SLICES),
              transformer_config=INTEROP_TRANSFORMS)
    first, second = ((jax_data, port_data) if writer == "jax"
                     else (port_data, jax_data))
    written = _patches(first.LazyHDF5Dataset(file_path=path, **kw))
    size = os.path.getsize(path)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["label", "raw", "raw_padded_1x2x2"]
        memo = f["raw_padded_1x2x2"][()]
    with hdf5.File(path) as g:
        _check_equal(g["raw_padded_1x2x2"][:], memo)
    _same_patches(_patches(second.LazyHDF5Dataset(file_path=path, **kw)),
                  written)
    assert os.path.getsize(path) == size  # read, not written again
    _compare_files(path)


@pytest.mark.parametrize("phase", ["test", "val"])
def test_standard_dataset_gives_jax_patches_on_a_latest_file(tmp_path,
                                                              phase):
    from mdeical_image_segmentation_tpu.data import hdf5 as jax_data
    from mdeical_image_segmentation_tpu_torch.data import hdf5 as port_data

    path = str(tmp_path / "vol.h5")
    _latest_volume(path)
    kw = dict(file_path=path, phase=phase,
              slice_builder_config=dict(INTEROP_SLICES),
              transformer_config=INTEROP_TRANSFORMS)
    _same_patches(_patches(port_data.StandardHDF5Dataset(**kw)),
                  _patches(jax_data.StandardHDF5Dataset(**kw)))


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")


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
    import json

    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()["h5_latest"]))
def test_h5_fixtures_match_the_manifest_in_h5py_and_the_port(name):
    """The manifest chip_smoke.py holds the port to on the card (which has
    no h5py) is what h5py reads from the committed files; the port reads
    the same, every dataset and every group's keys()."""
    script = _fixture_script()
    path = os.path.join(FIXTURES, "h5_latest", name)
    want = _manifest()["h5_latest"][name]
    assert script.h5_manifest(h5py, path) == want
    with hdf5.File(path) as g:
        for group, keys in want["groups"].items():
            assert g[group].keys() == keys
        for ds, entry in want["datasets"].items():
            assert script.entry(g[ds][()]) == entry, ds
