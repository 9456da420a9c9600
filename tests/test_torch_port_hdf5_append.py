"""The port's HDF5 codec (``utils/hdf5.py``) appending to files in place
(``"r+"``) and writing chunked datasets region by region, against h5py.

Appends go into files h5py wrote: a root group that ends with 1, 8 and 9
names (its local heap's free space overflowed; one symbol-table node of
2K = 8 entries filled, then a second one), 300 names (a B-tree of two
levels), a subgroup, a root whose object header h5py continued in a second
block (many attributes), and a path whose groups do not exist yet; and
into a file the port wrote, in turns with h5py.  h5py must read every old
and new dataset to the bit, and append to the file again after the port
did.  A chunked dataset written region by region
(overlapping windows, partial chunks, int indices, broadcasting) must read
back equal to the same writes on a numpy array, in h5py and in the port."""

import h5py
import numpy as np
import pytest

from mdeical_image_segmentation_tpu_torch.utils import hdf5


def _old(i):
    return np.arange(i + 3, dtype="<i2") * (i + 1)


def _h5py_file(path, n_names, subgroup=False, attrs=0):
    with h5py.File(path, "w") as f:
        for i in range(n_names):
            f.create_dataset(f"d{i:03d}", data=_old(i))
        if subgroup:
            f.create_dataset("grp/inner", data=_old(7))
        for i in range(attrs):
            f.attrs[f"a{i:02d}"] = np.arange(20) * i


@pytest.mark.parametrize("n_names", [1, 8, 9, 300])
def test_append_to_h5py_root_group(tmp_path, n_names):
    """The port adds the last name; 8 and 9 fill and cross a symbol-table
    node, 300 crosses the B-tree's 32-child root."""
    path = str(tmp_path / "f.h5")
    _h5py_file(path, n_names - 1)
    new = np.random.default_rng(n_names).standard_normal((6, 10, 12))
    with hdf5.File(path, "r+") as f:
        f.create_dataset("raw_padded_2x4x4", data=new.astype("<f4"),
                         compression="gzip")
        assert "raw_padded_2x4x4" in f and len(f.keys()) == n_names
    with h5py.File(path, "r") as f:
        assert sorted(f.keys()) == sorted(
            [f"d{i:03d}" for i in range(n_names - 1)] + ["raw_padded_2x4x4"])
        for i in range(n_names - 1):
            np.testing.assert_array_equal(f[f"d{i:03d}"][()], _old(i))
        ds = f["raw_padded_2x4x4"]
        assert (ds.compression, ds.compression_opts) == ("gzip", 4)
        np.testing.assert_array_equal(ds[()], new.astype("<f4"))
    # the library appends after the port, and everything still reads
    with h5py.File(path, "r+") as f:
        f.create_dataset("after", data=np.arange(5))
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert sorted(f.keys()) == sorted(g.keys())
        assert len(g.keys()) == n_names + 1
        np.testing.assert_array_equal(f["after"][()], np.arange(5))
        np.testing.assert_array_equal(g["raw_padded_2x4x4"][:],
                                      new.astype("<f4"))


@pytest.mark.parametrize("where", ["subgroup", "new_groups",
                                   "continued_header", "twice"])
def test_append_into_groups_and_reopened_files(tmp_path, where):
    path = str(tmp_path / "f.h5")
    _h5py_file(path, 3, subgroup=True,
               attrs=40 if where == "continued_header" else 0)
    name = {"subgroup": "grp/added", "new_groups": "x/y/added",
            "continued_header": "added", "twice": "added"}[where]
    data = np.random.default_rng(1).integers(0, 2**31, (9, 8), dtype="<u8")
    with hdf5.File(path, "r+") as f:
        f.create_dataset(name, data=data)
        if where == "twice":
            f.create_dataset("grp/second", data=data[:3], compression="gzip")
    if where == "twice":  # a second opening adds to what the first wrote
        with hdf5.File(path, "r+") as f:
            np.testing.assert_array_equal(f["grp/second"][:], data[:3])
            f.create_dataset("grp/third", data=data[::2])
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f[name][()], data)
        np.testing.assert_array_equal(f["grp/inner"][()], _old(7))
        for i in range(3):
            np.testing.assert_array_equal(f[f"d{i:03d}"][()], _old(i))
        if where == "continued_header":
            assert len(f.attrs) == 40
        if where == "twice":
            np.testing.assert_array_equal(f["grp/third"][()], data[::2])
            assert sorted(f["grp"].keys()) == ["inner", "second", "third"]


def test_opening_for_append_alone_leaves_the_file_untouched(tmp_path):
    path = str(tmp_path / "f.h5")
    _h5py_file(path, 4)
    before = open(path, "rb").read()
    with hdf5.File(path, "r+") as f:
        np.testing.assert_array_equal(f["d002"][:], _old(2))
        with pytest.raises(ValueError, match="already exists"):
            f.create_dataset("d002", data=_old(2))
        with pytest.raises(ValueError, match="d002 is a dataset"):
            f.create_dataset("d002/x", data=_old(2))
    assert open(path, "rb").read() == before


WRITES = [
    (np.s_[...], 1.5),
    (np.s_[0, 3:17, 5:40, 2:31], "rand"),
    (np.s_[1, :, 13], "rand"),
    (np.s_[:, 10:12, 0:7, -5:], "rand"),
    (np.s_[1, 16, 39, 32], -7.0),
    (np.s_[0:2, 0:17, 30:40, 0:33], "rand"),
]


@pytest.mark.parametrize("chunks,compression", [
    (True, "gzip"), ((1, 5, 7, 9), "gzip"), ((2, 17, 40, 33), None),
    ((1, 4, 13, 11), None)])
def test_region_writes_read_back_equal(tmp_path, chunks, compression):
    shape = (2, 17, 40, 33)
    path = str(tmp_path / "f.h5")
    rng = np.random.default_rng(0)
    want = np.zeros(shape, np.float32)
    with hdf5.File(path, "w") as f:
        f.create_dataset("raw", data=np.ones((3, 4), "u1"))
        ds = f.create_dataset("predictions", shape=shape, dtype="float32",
                              chunks=chunks, compression=compression)
        np.testing.assert_array_equal(ds[:], want)  # the fill value
        # the last case skips the whole write: some chunks stay unwritten
        writes = WRITES[1:] if chunks == (1, 4, 13, 11) else WRITES
        for i, (index, value) in enumerate(writes):
            if isinstance(value, str):
                value = rng.standard_normal(want[index].shape)
            ds[index] = value
            want[index] = value
            np.testing.assert_array_equal(ds[:], want, err_msg=f"write {i}")
        with pytest.raises(IndexError, match="unit steps"):
            ds[:, ::2] = 0.0
        with pytest.raises(hdf5.HDF5Error, match="made since"):
            f["raw"][0] = 1
    with h5py.File(path, "r") as f:
        ds = f["predictions"]
        assert ds.compression == compression
        assert ds.chunks == (hdf5.guess_chunk(shape, 4) if chunks is True
                             else chunks)
        np.testing.assert_array_equal(ds[()], want)
        np.testing.assert_array_equal(f["raw"][()], np.ones((3, 4), "u1"))
    with hdf5.File(path) as g:
        np.testing.assert_array_equal(g["predictions"][:], want)


def test_shape_datasets_need_chunks_and_a_dtype(tmp_path):
    with hdf5.File(str(tmp_path / "f.h5"), "w") as f:
        with pytest.raises(ValueError, match="chunked"):
            f.create_dataset("a", shape=(4, 4), dtype="f4")
        with pytest.raises(ValueError, match="a shape and a dtype"):
            f.create_dataset("b", shape=(4, 4))
        with pytest.raises(ValueError, match="scalar"):
            f.create_dataset("c", shape=(), dtype="f4", chunks=True)
    with hdf5.File(str(tmp_path / "f.h5")) as f:
        with pytest.raises(ValueError, match="not open for writing"):
            f.create_dataset("d", data=np.zeros(3))


def test_library_and_port_append_to_a_port_file_in_turns(tmp_path):
    """A file the port wrote (its heaps have no free space): h5py adds 20
    names to one of its groups and a new group, then the port adds one
    more; both read everything."""
    path = str(tmp_path / "f.h5")
    with hdf5.File(path, "w") as f:
        f.create_dataset("a/x", data=np.arange(10))
        f.create_dataset("b", data=np.ones((3, 4), "f4"), compression="gzip")
    with h5py.File(path, "r+") as f:
        for i in range(20):
            f.create_dataset(f"a/h{i:02d}", data=_old(i))
        f.create_dataset("c/d", data=np.zeros(5))
    with hdf5.File(path, "r+") as f:
        f.create_dataset("a/port", data=np.arange(3))
    with h5py.File(path, "r") as f, hdf5.File(path) as g:
        assert sorted(g.keys()) == sorted(f.keys()) == ["a", "b", "c"]
        assert sorted(g["a"].keys()) == sorted(f["a"].keys())
        assert len(f["a"]) == 22
        for i in range(20):
            np.testing.assert_array_equal(g[f"a/h{i:02d}"][:], _old(i))
        np.testing.assert_array_equal(f["a/port"][()], np.arange(3))
        np.testing.assert_array_equal(f["b"][()], np.ones((3, 4), "f4"))
