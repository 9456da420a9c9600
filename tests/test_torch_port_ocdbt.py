"""The port's read-only OCDBT reader (``utils/ocdbt.py``) and zarr v2 reader
(``utils/zarr2.py``) against tensorstore, which writes the orbax
checkpoints of the JAX package.

- The committed probes (``tests/fixtures/orbax/ocdbt``: uncompressed and
  zstd nodes, interior nodes of height 2 and more, out-of-line and empty
  values, an empty key, shared key prefixes, 41 versions with the older
  ones in version tree nodes, a deleted key) list and read equal to
  tensorstore's ``KvStore.list()`` and ``read()`` and to the manifest.
- Databases tensorstore writes here, over a grid of node sizes, inline
  limits, compression and version tree arities, the same; the root
  databases orbax writes over its per-process ones (the committed
  checkpoints, one and two processes) too.
- A flipped byte anywhere in a manifest or a node raises ``OcdbtError``
  (each part's crc32c), as do a truncated file, a missing data file and a
  numbered manifest.
- zarr v2: the committed arrays (edge chunks of grids the shape does not
  divide, both dimension separators, a fill value for unwritten chunks)
  and arrays tensorstore writes here of every dtype equal tensorstore's
  read; another compressor, filters, F order, a missing chunk without a
  fill value and an unread dtype raise naming ROADMAP item 19b.
"""

import json
import os
import shutil

import numpy as np
import pytest
import tensorstore as ts

from mdeical_image_segmentation_tpu_torch.utils import zarr2
from mdeical_image_segmentation_tpu_torch.utils.ocdbt import (
    KvStore,
    OcdbtError,
)

HERE = os.path.dirname(os.path.abspath(__file__))
ORBAX = os.path.join(HERE, "fixtures", "orbax")


def _manifest():
    with open(os.path.join(HERE, "fixtures", "manifest.json")) as f:
        return json.load(f)["orbax"]


PROBES = sorted(_manifest()["ocdbt"])
ZARRS = sorted(_manifest()["zarr"])
DATABASES = [os.path.join(d, w, *p) for d in ("tp/orbax", "zero1/orbax",
                                              "trees", "two_process")
             for w in ("last",)
             for p in ((), ("ocdbt.process_0",))]


def _tensorstore(path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{path}"}).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _port(path):
    kv = KvStore(path)
    return {k: kv.read(k) for k in kv.list()}


@pytest.mark.parametrize("name", PROBES)
def test_committed_probes_match_tensorstore(name):
    import hashlib

    path = os.path.join(ORBAX, name)
    got = _port(path)
    assert got == _tensorstore(path)
    assert {k.hex(): {"length": len(v),
                      "sha256": hashlib.sha256(v).hexdigest()}
            for k, v in got.items()} == _manifest()["ocdbt"][name]


@pytest.mark.parametrize("path", DATABASES)
def test_orbax_databases_match_tensorstore(path):
    path = os.path.join(ORBAX, path)
    assert _port(path) == _tensorstore(path)


def test_two_process_root_points_into_both_process_databases():
    root = os.path.join(ORBAX, "two_process", "last")
    keys = set(_port(root))
    parts = [set(_port(os.path.join(root, f"ocdbt.process_{i}")))
             for i in range(2)]
    assert parts[0] and parts[1] and keys == parts[0] | parts[1]


CONFIGS = [
    {"compression": None, "max_decoded_node_bytes": 48,
     "max_inline_value_bytes": 0},
    {"compression": {"id": "zstd", "level": 1},
     "max_decoded_node_bytes": 80, "max_inline_value_bytes": 16},
    {"compression": {"id": "zstd", "level": 19},
     "max_decoded_node_bytes": 4096, "max_inline_value_bytes": 100,
     "version_tree_arity_log2": 1},
    {"compression": None, "max_inline_value_bytes": 1024},
]


@pytest.mark.parametrize("config", range(len(CONFIGS)))
def test_databases_written_here_match_tensorstore(tmp_path, config):
    rng = np.random.default_rng(config)
    path = tmp_path / "db"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": CONFIGS[config]}).result()
    keys = [f"{p}/{i:03d}".encode() for p in ("a", "a/b", "model.params",
                                              "zz") for i in range(25)]
    for round_ in range(3):  # three versions, rewriting some keys
        with ts.Transaction() as txn:
            t = kv.with_transaction(txn)
            for k in keys[round_::2]:
                n = int(rng.integers(0, 200))
                t.write(k, rng.integers(0, 256, n, np.uint8).tobytes()
                        ).result()
    assert _port(path) == _tensorstore(path)


def _copy(tmp_path, name):
    dst = tmp_path / "copy"
    shutil.copytree(os.path.join(ORBAX, name), dst)
    return dst


@pytest.mark.parametrize("part", ["manifest", "node"])
def test_a_flipped_byte_raises(tmp_path, part):
    db = _copy(tmp_path, "ocdbt/zstd_deep")
    target = (db / "manifest.ocdbt" if part == "manifest"
              else sorted((db / "d").iterdir())[0])
    data = target.read_bytes()
    if part == "node":
        # the nodes of a data file: flip a byte inside the last one
        start = data.rfind(b"\x0c\xdb\x20\xde")
        positions = range(start, len(data))
    else:
        positions = range(len(data))
    for i in list(positions)[::7]:
        bad = bytearray(data)
        bad[i] ^= 0x10
        target.write_bytes(bytes(bad))
        with pytest.raises(OcdbtError):
            _port(db)
    target.write_bytes(data)
    assert _port(db) == _tensorstore(db)


def test_truncated_and_missing_files_raise(tmp_path):
    db = _copy(tmp_path, "ocdbt/plain_deep")
    manifest = (db / "manifest.ocdbt").read_bytes()
    (db / "manifest.ocdbt").write_bytes(manifest[:-3])
    with pytest.raises(OcdbtError, match="length"):
        KvStore(str(db))
    (db / "manifest.ocdbt").write_bytes(manifest)
    for f in (db / "d").iterdir():
        f.unlink()
    with pytest.raises(OcdbtError, match="data file"):
        KvStore(str(db))
    with pytest.raises(OcdbtError, match="no manifest.ocdbt"):
        KvStore(str(tmp_path))


def test_a_numbered_manifest_raises(tmp_path):
    path = tmp_path / "db"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": {"manifest_kind": "numbered"}}).result()
    kv.write(b"k", b"v").result()
    with pytest.raises(OcdbtError, match="19b"):
        KvStore(str(path))


def _zarr_get(kv):
    return lambda key: kv.read(key) if key in kv else None


@pytest.mark.parametrize("name", ZARRS)
def test_committed_zarr_arrays_match_tensorstore(name):
    want = np.asarray(ts.open({
        "driver": "zarr", "path": name.split("/", 1)[1],
        "kvstore": {"driver": "ocdbt",
                    "base": f"file://{os.path.join(ORBAX, 'zarr')}"}},
        read=True).result().read().result())
    got = zarr2.read_array(_zarr_get(KvStore(os.path.join(ORBAX, "zarr"))),
                           name.split("/", 1)[1])
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    entry = _manifest()["zarr"][name]
    assert [list(got.shape), got.dtype.str] == [entry["shape"],
                                                entry["dtype"]]


DTYPES = ["<f4", "<f8", "<i4", "<i8", "|b1", "|u1", "<i2", "<u4", "<f2",
          "<c8"]


@pytest.mark.parametrize("dtype", DTYPES)
def test_zarr_arrays_of_every_dtype(tmp_path, dtype):
    rng = np.random.default_rng(1)
    data = (rng.standard_normal((11, 7, 5)) * 50).astype(np.dtype(dtype))
    for sep, compressor in (("/", {"id": "zstd", "level": 3}), (".", None)):
        path = tmp_path / f"a{sep == '/'}"
        arr = ts.open({"driver": "zarr", "kvstore": f"file://{path}",
                       "metadata": {"shape": [11, 7, 5], "chunks": [4, 3, 5],
                                    "dtype": dtype, "compressor": compressor,
                                    "dimension_separator": sep}},
                      create=True).result()
        arr.write(data).result()

        def get(key, root=path):
            f = root / key.split("/", 1)[1]
            return f.read_bytes() if f.exists() else None

        got = zarr2.read_array(get, "a")
        np.testing.assert_array_equal(got, np.asarray(arr.read().result()))
        assert got.dtype == np.dtype(dtype)


def _zarray(**meta):
    base = {"zarr_format": 2, "shape": [4], "chunks": [4], "dtype": "<f4",
            "compressor": None, "fill_value": None, "order": "C",
            "filters": None, "dimension_separator": "."}
    base.update(meta)
    store = {"x/.zarray": json.dumps(base).encode(),
             "x/0": np.arange(4, dtype=np.float32).tobytes()}
    return store.get


@pytest.mark.parametrize("meta", [
    {"compressor": {"id": "blosc"}},
    {"filters": [{"id": "delta", "dtype": "<f4"}]},
    {"order": "F"},
    {"dtype": "bfloat16"},
    {"dtype": "|S4"},
    {"zarr_format": 3},
    {"shape": [8]},  # chunk 1 is missing, no fill_value
], ids=["blosc", "filters", "order_F", "bfloat16", "bytes", "zarr3",
        "missing_chunk"])
def test_unread_zarr_arrays_raise_naming_the_item(meta):
    with pytest.raises(zarr2.ZarrError, match="19b"):
        zarr2.read_array(_zarray(**meta), "x")


def test_zarr_fill_value_stands_for_a_missing_chunk():
    got = zarr2.read_array(_zarray(shape=[6], fill_value="NaN"), "x")
    np.testing.assert_array_equal(got[:4], np.arange(4))
    assert np.isnan(got[4:]).all()


def test_a_short_chunk_raises():
    get = _zarray()
    store = {"x/.zarray": get("x/.zarray"), "x/0": get("x/0")[:-1]}
    with pytest.raises(zarr2.ZarrError, match="bytes"):
        zarr2.read_array(store.get, "x")
