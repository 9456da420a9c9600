"""Write the HDF5 and PNG fixtures the port's reader is held against, and
their manifest.

    python scripts/make_port_fixtures.py [--out tests/fixtures]

Needs h5py, imageio and PIL (the CPU tests' machine has them; the card's
machine does not, which is why the manifest exists).  Writes:

- ``h5_latest/*.h5``: one tiny file per case of the reader's matrix
  (superblocks 0, 2 and 3; every layout and chunk index; LZF, Fletcher-32,
  scale-offset, gzip + shuffle; bool, float16, an enum and the integer and
  float types; compact, dense, ``track_order``, nested and soft-linked
  groups; a paged file-space superblock extension) and
  ``phantom_latest.h5``: an (80, 340, 340) uint8 volume of seeded
  constant-intensity spheres, ``libver="latest"``, shuffle + gzip, chunks
  under a version-2 B-tree index (every axis unlimited).
- ``png_extra/dsb_c{1,3,4}/images/*.png``: PNGs imageio decodes to 1, 3
  and 4 channels: palette at 1, 2, 4 and 8 bits with and without tRNS;
  1-, 2- and 4-bit grey; 16-bit RGB, grey + alpha and RGBA; each also
  Adam7-interlaced (PIL writes no interlaced PNGs, so this script encodes
  every PNG itself).
- ``manifest.json``: for every dataset reachable from each file's root (soft
  links followed) its shape, dtype and the SHA-256 of its C-order bytes as
  h5py reads it, and each group's ``keys()``; for every PNG, the same of
  what ``imageio.imread`` and PIL's ``convert("L")`` / ``convert("RGB")``
  give.

Everything comes from ``numpy.random.default_rng`` with fixed seeds, so a
rerun writes the same arrays (h5py may lay the bytes out differently).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import struct
import zlib

import numpy as np

SEED = 20
PHANTOM_SHAPE = (80, 340, 340)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# -- PNG ---------------------------------------------------------------------


def _filter_row(ftype: int, cur: bytes, prev: bytes, bpp: int) -> bytes:
    out = bytearray(len(cur))
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 0:
            pred = 0
        elif ftype == 1:
            pred = a
        elif ftype == 2:
            pred = b
        elif ftype == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) & 0xFF
    return bytes(out)


def _pack_rows(samples: np.ndarray, depth: int) -> np.ndarray:
    """(H, W, ch) sample values → (H, stride) bytes, one image row each."""
    h, w, ch = samples.shape
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, w * ch * 2)
    bits = ((samples.reshape(h, w * ch, 1).astype(np.uint8)
             >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1)
    return np.packbits(bits.reshape(h, -1), axis=1)


def _filtered(samples: np.ndarray, depth: int, filters) -> bytes:
    """Rows of one (reduced) image, row r filtered by filters[r % n]."""
    h, w, ch = samples.shape
    if h == 0 or w == 0:
        return b""
    rows = _pack_rows(samples, depth)
    bpp = max(ch * depth // 8, 1)
    out, prev = [], bytes(rows.shape[1])
    for r in range(h):
        cur = rows[r].tobytes()
        ftype = filters[r % len(filters)]
        out.append(bytes([ftype]) + _filter_row(ftype, cur, prev, bpp))
        prev = cur
    return b"".join(out)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def encode_png(samples: np.ndarray, colour_type: int, depth: int,
               palette: np.ndarray = None, trns: bytes = None,
               interlace: bool = False, filters=(0, 1, 2, 3, 4)) -> bytes:
    """PNG bytes of ``samples`` (H, W, channels), of any colour type and
    depth the format allows, plain or Adam7-interlaced (each pass's rows
    filtered on their own, as the format asks)."""
    h, w, _ = samples.shape
    if interlace:
        data = b"".join(_filtered(samples[y0::dy, x0::dx], depth, filters)
                        for x0, y0, dx, dy in ADAM7)
    else:
        data = _filtered(samples, depth, filters)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, colour_type, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(data)) + _chunk(b"IEND", b"")


def png_cases(rng, h: int = 32, w: int = 48):
    """{name: (PNG bytes, imageio's channel count)}: the palette, sub-byte
    and 16-bit colour PNGs, each plain and interlaced."""
    cases = {}
    for depth in (1, 2, 4, 8):
        n = min(1 << depth, 200)
        palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
        idx = rng.integers(0, n, (h, w, 1))
        cases[f"palette{depth}"] = (3, dict(samples=idx, colour_type=3,
                                            depth=depth, palette=palette))
        alpha = rng.integers(0, 256, n // 2 + 1, dtype=np.uint8).tobytes()
        cases[f"palette{depth}_trns"] = (3, dict(
            samples=idx, colour_type=3, depth=depth, palette=palette,
            trns=alpha))
    for depth in (1, 2, 4):
        cases[f"grey{depth}"] = (1, dict(
            samples=rng.integers(0, 1 << depth, (h, w, 1)), colour_type=0,
            depth=depth))
    cases["rgb16"] = (3, dict(samples=rng.integers(0, 1 << 16, (h, w, 3)),
                              colour_type=2, depth=16))
    cases["grey_alpha16"] = (4, dict(
        samples=rng.integers(0, 1 << 16, (h, w, 2)), colour_type=4,
        depth=16))
    cases["rgba16"] = (4, dict(samples=rng.integers(0, 1 << 16, (h, w, 4)),
                               colour_type=6, depth=16))
    out = {}
    for name, (ch, kw) in cases.items():
        out[name] = (encode_png(**kw), ch)
        out[f"{name}_adam7"] = (encode_png(interlace=True, **kw), ch)
    return out


# -- HDF5 --------------------------------------------------------------------


def _early_dcpl(h5py):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_alloc_time(h5py.h5d.ALLOC_TIME_EARLY)
    return dcpl


def _compact(h5py, f, name, data):
    dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
    dcpl.set_layout(h5py.h5d.COMPACT)
    h5py.h5d.create(f.id, name.encode(), h5py.h5t.py_create(data.dtype),
                    h5py.h5s.create_simple(data.shape), dcpl=dcpl).write(
        h5py.h5s.ALL, h5py.h5s.ALL, data)


def phantom(shape=PHANTOM_SHAPE, seed: int = SEED, n: int = 24):
    """A uint8 volume of ``n`` seeded spheres, each of one intensity."""
    rng = np.random.default_rng(seed)
    vol = np.zeros(shape, np.uint8)
    grid = np.ogrid[tuple(slice(0, s) for s in shape)]
    for _ in range(n):
        centre = [rng.uniform(0, s) for s in shape]
        radius = rng.uniform(8, 40)
        value = rng.integers(40, 250)
        d2 = sum((g - c) ** 2 for g, c in zip(grid, centre))
        vol[d2 <= radius ** 2] = value
    return vol


def h5_cases(h5py, rng):
    """{file name: (libver, track_order, writer(f))}."""
    vol = rng.standard_normal((6, 10, 11)).astype("<f4") * 100
    ints = rng.integers(0, 1000, (6, 10, 11)).astype("<i2")

    def chunked(**kw):
        return lambda f: f.create_dataset("x", data=vol, **kw)

    def paged(f):  # 1200 chunks: a paged fixed array, two pages written
        ds = f.create_dataset("x", shape=(40, 60), dtype="<u2",
                              chunks=(1, 2), fillvalue=3)
        ds[0:2, 0:4] = np.arange(8).reshape(2, 4)
        ds[39, 50:60] = 9

    def sparse(f):  # an extensible array mostly unwritten
        ds = f.create_dataset("x", shape=(400, 6), dtype="<i2",
                              chunks=(2, 3), maxshape=(None, 6),
                              fillvalue=-7, compression="lzf")
        ds[0:2, 3:6] = 1
        ds[57, :] = np.arange(6)
        ds[399, 0] = 5

    def dtypes(f):
        for o in "<>":
            for k, n in [("u", 1), ("u", 2), ("u", 4), ("u", 8), ("i", 1),
                         ("i", 2), ("i", 4), ("i", 8), ("f", 2), ("f", 4),
                         ("f", 8)]:
                dt = np.dtype(f"{o}{k}{n}")
                if k == "f":
                    a = rng.standard_normal((3, 4, 5)) * 10
                else:
                    info = np.iinfo(dt)
                    a = rng.integers(info.min, info.max, (3, 4, 5),
                                     endpoint=True, dtype=dt.newbyteorder("="))
                f.create_dataset(f"{'le' if o == '<' else 'be'}_{k}{n}",
                                 data=np.asarray(a, dt), chunks=(2, 2, 5),
                                 compression="gzip")
        f.create_dataset("label_bool", data=vol > 0)
        f.create_dataset("label_bool_chunked", data=vol > 50,
                         chunks=(3, 5, 11), compression="gzip")
        f.create_dataset("enum_i2", data=np.array([0, 42, 1], "<i2"),
                         dtype=h5py.enum_dtype({"RED": 0, "GREEN": 1,
                                                "BLUE": 42}, basetype="<i2"))

    def groups(n, nested=True):
        def write(f):
            for i in range(n):
                f.create_dataset(f"d{(7 * i) % n:02d}", data=np.arange(i + 2))
            if nested:
                g = f.create_group("nested", track_order=True)
                for i in range(n):
                    g.create_dataset(f"z{n - i:02d}", data=np.full(3, i))
                inner = g.create_group("inner")
                inner.create_dataset("deep", data=np.eye(3))
                f["soft_abs"] = h5py.SoftLink("/nested/inner/deep")
                g["soft_rel"] = h5py.SoftLink("inner")
        return write

    return {
        "sb0_default_chunked.h5": ("earliest", False, chunked(
            chunks=(2, 5, 4), compression="gzip")),
        "sb2_v108_chunked.h5": ("v108", False, chunked(chunks=(2, 5, 4))),
        "sb3_v110_earray.h5": ("v110", False, chunked(
            chunks=(2, 5, 4), maxshape=(None, 10, 11))),
        "latest_contiguous.h5": ("latest", False, chunked()),
        "latest_compact.h5": ("latest", False,
                              lambda f: _compact(h5py, f, "x", ints)),
        "latest_single.h5": ("latest", False, chunked(chunks=vol.shape)),
        "latest_single_gzip.h5": ("latest", False, chunked(
            chunks=vol.shape, compression="gzip")),
        "latest_implicit.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), dcpl=_early_dcpl(h5py))),
        "latest_farray.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), compression="gzip", shuffle=True)),
        "latest_farray_paged.h5": ("latest", False, paged),
        "latest_earray.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), maxshape=(6, None, 11))),
        "latest_earray_sparse.h5": ("latest", False, sparse),
        "latest_bt2.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), maxshape=(None, None, 11),
            compression="gzip")),
        "latest_bt2_deep.h5": ("latest", False, lambda f: f.create_dataset(
            "x", data=np.arange(800, dtype="<f8").reshape(50, 16),
            chunks=(1, 4), maxshape=(None, None))),
        "filter_lzf.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), compression="lzf", shuffle=True)),
        "filter_fletcher32.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), fletcher32=True)),
        "filter_scaleoffset_int.h5": ("latest", False, lambda f:
                                      f.create_dataset(
                                          "x", data=ints, chunks=(2, 5, 4),
                                          scaleoffset=True)),
        "filter_scaleoffset_float.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), scaleoffset=2, compression="gzip")),
        "filter_gzip_shuffle_default.h5": ("earliest", False, chunked(
            chunks=(2, 5, 4), compression="gzip", compression_opts=9,
            shuffle=True, fletcher32=True)),
        "dtypes_latest.h5": ("latest", False, dtypes),
        "groups_compact.h5": ("latest", False, groups(3)),
        "groups_dense.h5": ("latest", False, groups(12)),
        "groups_track_order.h5": ("latest", True, groups(12)),
        "groups_default_track_root.h5": ("earliest", True, groups(5)),
        "superblock_ext_paged.h5": ("latest", False, chunked(
            chunks=(2, 5, 4), compression="gzip")),
    }


def sha256(a: np.ndarray) -> str:
    """Of the C-order bytes; a bool array's as 0 and 1 (PIL's 1-bit images
    hold True as 255)."""
    if a.dtype == bool:
        a = np.frombuffer(np.ascontiguousarray(a).tobytes(), np.uint8) != 0
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def entry(a: np.ndarray) -> dict:
    return {"shape": list(a.shape), "dtype": a.dtype.str, "sha256": sha256(a)}


def h5_manifest(h5py, path: str) -> dict:
    """Every dataset reachable from the root by keys() (soft links
    followed), and each group's keys()."""
    datasets, groups = {}, {}
    with h5py.File(path, "r") as f:
        def walk(g, prefix):
            groups[prefix or "/"] = list(g.keys())
            for k in g.keys():
                obj = g[k]
                if isinstance(obj, h5py.Group):
                    walk(obj, f"{prefix}/{k}")
                else:
                    datasets[f"{prefix}/{k}"] = entry(obj[()])
        walk(f, "")
    return {"datasets": datasets, "groups": groups}


def png_manifest(path: str) -> dict:
    import imageio
    from PIL import Image

    with Image.open(path) as im:
        out = {"pil_" + m: entry(np.asarray(im.convert(m)))
               for m in ("L", "RGB")}
    out["imageio"] = entry(np.asarray(imageio.imread(path)))
    return out


def main(argv=None) -> int:
    import h5py

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(here, "tests",
                                                      "fixtures"))
    args = parser.parse_args(argv)
    manifest = {"h5_latest": {}, "png_extra": {}}
    h5_dir = os.path.join(args.out, "h5_latest")
    os.makedirs(h5_dir, exist_ok=True)
    rng = np.random.default_rng(SEED)
    for name, (libver, track, write) in h5_cases(h5py, rng).items():
        path = os.path.join(h5_dir, name)
        kw = ({"fs_strategy": "page", "fs_page_size": 4096}
              if "paged" in name and "superblock" in name else {})
        with h5py.File(path, "w", libver=libver, track_order=track,
                       **kw) as f:
            write(f)
        manifest["h5_latest"][name] = h5_manifest(h5py, path)
    path = os.path.join(h5_dir, "phantom_latest.h5")
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("raw", data=phantom(), chunks=(40, 85, 85),
                         maxshape=(None, None, None), shuffle=True,
                         compression="gzip")
    manifest["h5_latest"]["phantom_latest.h5"] = h5_manifest(h5py, path)
    rng = np.random.default_rng(SEED + 1)
    for name, (data, ch) in png_cases(rng).items():
        d = os.path.join(args.out, "png_extra", f"dsb_c{ch}", "images")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name}.png")
        with open(path, "wb") as f:
            f.write(data)
        manifest["png_extra"][f"dsb_c{ch}/images/{name}.png"] = png_manifest(
            path)
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(r, n))
                for r, _, names in os.walk(args.out) for n in names)
    print(f"wrote {args.out}: {total} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
