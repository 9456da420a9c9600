"""The port's HDF5 codec (``utils/hdf5.py``) against h5py: files h5py writes
by default (superblock 0) read equal in the port — contiguous, compact and
chunked layouts, gzip at every level, shuffle, nested groups, every integer
and float type in both byte orders, multi-level chunk B-trees, windowed
reads — and files the port writes read equal in h5py, with
``.compression == "gzip"`` where asked.  Files outside the codec's subset
raise and name what they hold.  Everything compares equal: values, names,
shapes and dtypes."""

import os

import h5py
import numpy as np
import pytest

from mdeical_image_segmentation_tpu_torch.utils import hdf5

DTYPES = [f"{o}{k}{n}" for o in "<>" for k, n in
          [("u", 1), ("u", 2), ("u", 4), ("u", 8), ("i", 1), ("i", 2),
           ("i", 4), ("i", 8), ("f", 4), ("f", 8)]]


def _data(dtype, shape=(5, 7, 9), seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a = rng.standard_normal(shape) * 1e3
    else:
        info = np.iinfo(dt)
        a = rng.integers(info.min, info.max, size=shape, endpoint=True,
                         dtype=dt.newbyteorder("="))
    return np.asarray(a, dtype=dt)


def _check_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("layout", ["contiguous", "chunked_gzip", "compact"])
def test_h5py_datasets_read_equal(tmp_path, dtype, layout):
    path = str(tmp_path / "f.h5")
    data = _data(dtype)
    kw = {"contiguous": {}, "compact": {},
          "chunked_gzip": {"chunks": (2, 3, 4), "compression": "gzip"}}[layout]
    with h5py.File(path, "w") as f:
        if layout == "compact":
            dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
            dcpl.set_layout(h5py.h5d.COMPACT)
            space = h5py.h5s.create_simple(data.shape)
            tid = h5py.h5t.py_create(data.dtype)
            h5py.h5d.create(f.id, b"x", tid, space, dcpl=dcpl).write(
                h5py.h5s.ALL, h5py.h5s.ALL, data)
        else:
            f.create_dataset("x", data=data, **kw)
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        want, ds = f["x"], g["x"]
        assert (ds.shape, ds.dtype, ds.chunks, ds.compression) == (
            want.shape, want.dtype, want.chunks, want.compression)
        _check_equal(ds[:], want[()])
        _check_equal(ds[1:4, ::2, -3], want[1:4, ::2, -3])


@pytest.mark.parametrize("level", range(1, 10))
def test_h5py_gzip_levels_and_shuffle_read_equal(tmp_path, level):
    path = str(tmp_path / "f.h5")
    data = _data("<f4", (6, 20, 30), seed=level)
    with h5py.File(path, "w") as f:
        f.create_dataset("g", data=data, compression="gzip",
                         compression_opts=level, shuffle=level % 2 == 0,
                         chunks=(4, 7, 11))
    with hdf5.File(path) as g:
        ds = g["g"]
        assert (ds.compression, ds.compression_opts, ds.shuffle) == (
            "gzip", level, level % 2 == 0)
        _check_equal(ds[:], data)


@pytest.mark.parametrize("index", [
    np.s_[:], np.s_[...], np.s_[3], np.s_[-1, 5:40], np.s_[2:9, 13:77:3],
    np.s_[..., 63], np.s_[:, :, 0:64], np.s_[1:1], np.s_[0:2, 70:900],
])
def test_windowed_reads_touch_only_their_chunks(tmp_path, index):
    """A read through a multi-level chunk B-tree (2025 chunks: more than a
    64-entry node) decodes only the chunks its window overlaps."""
    path = str(tmp_path / "f.h5")
    data = _data("<i4", (12, 75, 91))
    with h5py.File(path, "w") as f:
        f.create_dataset("a/b/c", data=data, chunks=(4, 5, 3),
                         compression="gzip")
    with hdf5.File(path) as g:
        ds = g["a/b/c"]
        decoded = []
        orig = ds._decode_chunk
        ds._decode_chunk = lambda *e: decoded.append(e) or orig(*e)
        got = ds[index]
        _check_equal(got, data[index])
        box, _ = hdf5._normalize_index(index, data.shape)
        want = 1
        for (a, b), c in zip(box, ds.chunks):
            want *= 0 if b <= a else (b - 1) // c - a // c + 1
        assert len(decoded) == want


def test_h5py_groups_scalars_and_unwritten_chunks_read_equal(tmp_path):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        for i in range(40):  # more than one symbol-table node
            f.create_dataset(f"many/d{i:02d}", data=np.arange(i + 1))
        f.create_dataset("deep/er/est/x", data=np.float64(3.5))
        f.create_dataset("empty", shape=(0, 3), dtype="i2")
        f.create_dataset("filled", shape=(10, 10), dtype="f4",
                         chunks=(3, 3), fillvalue=-2.0)
        f["filled"][0:3, 0:3] = 1.0
        f.attrs["note"] = "attributes are skipped"
        f["many"].attrs["n"] = 40
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert sorted(g.keys()) == sorted(f.keys())
        assert sorted(g["many"].keys()) == sorted(f["many"].keys())
        for i in range(40):
            _check_equal(g[f"many/d{i:02d}"][:], f[f"many/d{i:02d}"][()])
        _check_equal(g["deep/er/est/x"][()], np.asarray(f["deep/er/est/x"][()]))
        _check_equal(g["empty"][:], f["empty"][()])
        _check_equal(g["filled"][:], f["filled"][()])
        assert "deep/er" in g and "deep/nope" not in g and "many/d39" in g
        with pytest.raises(KeyError):
            g["many/d99"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("compression", [None, "gzip"])
def test_port_writes_read_equal_in_h5py(tmp_path, dtype, compression):
    path = str(tmp_path / "f.h5")
    data = _data(dtype, (9, 33, 40))
    with hdf5.File(path, "w") as f:
        f.create_dataset("vol/raw", data=data, compression=compression)
        f.create_dataset("scalar", data=np.asarray(data[0, 0, 0]))
        f.create_dataset("empty", data=data[:0], compression=compression)
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == ["empty", "scalar", "vol"]
        _check_equal(f["empty"][()], data[:0])
        ds = f["vol/raw"]
        assert ds.compression == compression
        if compression:
            assert ds.compression_opts == 4
            assert ds.chunks == hdf5.guess_chunk(data.shape,
                                                 data.dtype.itemsize)
        _check_equal(ds[()], data)
        _check_equal(np.asarray(f["scalar"][()]), np.asarray(data[0, 0, 0]))
    with hdf5.File(path) as g:  # and back through the port's reader
        _check_equal(g["vol/raw"][:], data)
        _check_equal(g["empty"][:], data[:0])


def test_port_writes_multi_level_chunk_trees_and_big_groups(tmp_path):
    """A chunk B-tree of two levels (about 500 chunks, more than a 64-entry
    node), a group of 200 members (25 symbol-table nodes)."""
    path = str(tmp_path / "f.h5")
    big = _data("<f4", (96, 128, 128), seed=3)
    with hdf5.File(path, "w") as f:
        f.create_dataset("p/big", data=big, compression="gzip")
        for i in range(200):
            f.create_dataset(f"g/m{i:03d}", data=np.full((2,), i, "u2"))
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("p/big", data=big)
        with pytest.raises(ValueError, match="only 'gzip'"):
            f.create_dataset("x", data=big, compression="lzf")
        # a file open for writing reads back what it holds so far
        assert "p/big" in f and "g/m199" in f and "g/m200" not in f
        _check_equal(f["g/m123"][:], np.full((2,), 123, "u2"))
    with h5py.File(path, "r") as f:
        ds = f["p/big"]
        n_chunks = np.prod([-(-n // c) for n, c in zip(big.shape,
                                                       ds.chunks)])
        assert n_chunks > 2 * hdf5.CHUNK_K
        assert (ds.compression, ds.compression_opts) == ("gzip", 4)
        _check_equal(ds[()], big)
        _check_equal(ds[7:19, 40, ::5], big[7:19, 40, ::5])
        assert len(f["g"]) == 200
        for i in (0, 7, 8, 123, 199):
            _check_equal(f[f"g/m{i:03d}"][()], np.full((2,), i, "u2"))


def test_guess_chunk_is_h5pys():
    from h5py._hl import filters

    for shape, itemsize in [((80, 340, 510), 4), ((1, 80, 340, 510), 4),
                            ((7,), 8), ((3, 5), 1), ((100000, 3), 2),
                            ((0, 7), 4)]:
        assert hdf5.guess_chunk(shape, itemsize) == filters.guess_chunk(
            shape, None, itemsize)


@pytest.mark.parametrize("libver,make,what", [
    ("latest", lambda f: f.create_dataset("x", data=np.zeros(3)),
     "superblock version"),
    ("earliest", lambda f: f.create_dataset(
        "x", data=np.zeros((4, 4)), chunks=(2, 2), fletcher32=True),
     "filter 3"),
    ("earliest", lambda f: f.create_dataset(
        "x", data=np.zeros((4, 4)), chunks=(2, 2), compression="lzf"),
     "filter 32000"),
    ("earliest", lambda f: f.create_dataset(
        "x", data=np.zeros(3, dtype=[("a", "<i4"), ("b", "<f4")])),
     "compound"),
    ("earliest", lambda f: f.create_dataset(
        "x", data=np.array([b"ab", b"cd"])), "string"),
    ("earliest", lambda f: f.create_dataset(
        "x", data=np.zeros(3, np.float16)), "float of 2 bytes"),
    ("earliest", lambda f: f.__setitem__("x", h5py.SoftLink("/y")),
     "soft links"),
])
def test_unsupported_files_raise_and_name_what_they_hold(tmp_path, libver,
                                                         make, what):
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w", libver=libver) as f:
        make(f)
    with pytest.raises(hdf5.HDF5Error, match=what):
        with hdf5.File(path) as f:
            f["x"][()]


def test_not_an_hdf5_file_and_bad_modes_raise(tmp_path):
    path = tmp_path / "f.h5"
    path.write_bytes(b"not hdf5" * 20)
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        hdf5.File(str(path))
    with pytest.raises(hdf5.HDF5Error, match="not an HDF5 file"):
        hdf5.File(str(path), "r+")
    with pytest.raises(ValueError, match="'r', 'r\\+' or 'w'"):
        hdf5.File(str(path), "a")
    with hdf5.File(str(tmp_path / "w.h5"), "w") as f:
        with pytest.raises(KeyError, match="no object"):
            f["x"]
    assert os.path.getsize(tmp_path / "w.h5") > 0
