"""Every source under the port's ``csrc/`` ships in its package data: the
kernels (``*.cu``, ``*.cuh``) and the host C (``*.c``: the PNG decoder's
unfilter, HDF5's LZF, szip and n-bit, the TIFF and GIF readers' LZW and
PackBits, the JPEG decoder, the orbax reader's zstd) are built from source
at first use, so a wheel that leaves one out breaks that path at its first
call."""

import fnmatch
import os
import tomllib

import mdeical_image_segmentation_tpu_torch as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = port.__name__


def _patterns():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"][PKG]


def test_every_csrc_file_matches_a_package_data_pattern():
    patterns = _patterns()
    csrc = os.path.join(os.path.dirname(port.__file__), "csrc")
    files = sorted(os.listdir(csrc))
    assert {"png_unfilter.c", "lzf_decompress.c", "lzw_decode.c",
            "jpeg_decode.c", "zstd_decompress.c", "szip_decompress.c",
            "nbit_decompress.c", "conv_tc.cuh", "int8_conv.cu"} <= set(files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f"csrc/{f}", p) for p in patterns)]
    assert not missing, f"not in {PKG}'s package data {patterns}: {missing}"


def test_package_data_lists_the_c_sources():
    assert "csrc/*.c" in _patterns()
