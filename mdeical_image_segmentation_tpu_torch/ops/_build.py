"""Build the port's CUDA kernels at first use and load them with ctypes.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them in seconds (``torch.utils.cpp_extension``, which compiles against
PyTorch's headers, takes minutes).  Each source is compiled to an object by
its own ``nvcc``, all started together, and the objects are linked into one
shared library in ``build/torch_kernels/`` at the root of the checkout,
named by a hash of the flags and of every file under ``csrc/`` (the sources
and the headers they include, such as the shared ``conv_tc.cuh``), so an
edited source or header is rebuilt and an unchanged tree is reused.  The library is written to a temporary file and
renamed into place, so two processes never load a half-written library.

Plain C sources under ``csrc/`` (``*.c``, host code such as the PNG
decoder's unfilter) are built the same way by ``host_library`` with the
host C compiler, one library per source.

Nothing here runs at import: ``load()`` builds and loads on the first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional, Tuple

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("double_conv2d.cu", "group_norm.cu", "gcr_conv3d.cu",
           "overlap_add.cu")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # print registers, shared memory and spills per kernel into the build log
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``.  Raises if there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from source at first use and need the CUDA toolkit"
    )


def nvcc_commands(nvcc: str, out: Path, objdir: Path,
                  ) -> Tuple[List[List[str]], List[str]]:
    """(one compile command per source, the link command into ``out``)."""
    objs = [objdir / (Path(s).stem + ".o") for s in SOURCES]
    compiles = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", "-o", str(o),
                 str(CSRC / s)]
                for s, o in zip(SOURCES, objs)]
    link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out), *map(str, objs)]
    return compiles, link


def library_path() -> Path:
    """The library's path, named by the flags and every ``*.cu`` and
    ``*.cuh`` file under ``CSRC``."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtpuseg_kernels_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def _run_all(cmds: List[List[str]]) -> Tuple[List[int], str]:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    rcs, log = [], ""
    for c, p in zip(cmds, procs):
        out, _ = p.communicate()
        rcs.append(p.returncode)
        log += f"$ {' '.join(c)}\n{out}"
    return rcs, log


def _compile(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    with tempfile.TemporaryDirectory(dir=path.parent) as objdir:
        compiles, link = nvcc_commands(find_nvcc(), tmp, Path(objdir))
        rcs, log = _run_all(compiles)
        if not any(rcs):
            rc, link_log = _run_all([link])
            rcs += rc
            log += link_log
    if any(rcs):
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rcs {rcs}):\n{log}")
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)


def _declare(lib: ctypes.CDLL) -> None:
    p, i, q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    signatures = {
        # x, w1, b1, w2, b2, y, z, N, H, W, Ci, C1, Co, dtype, device, stream
        "tpuseg_double_conv2d_forward": [p] * 7 + [i] * 8 + [p],
        # aligned, bwd, N, S, C, dtype, device -> G of the two below
        "tpuseg_gn_reduce_blocks": [i, i, i, q, i, i, i],
        # x, partial, s1, s2, N, S, C, G, dtype, device, stream
        "tpuseg_gn_stats": [p] * 4 + [i, q, i, i, i, i, p],
        # x, a, b, y, N, S, C, dtype, device, stream (the grid from the card)
        "tpuseg_gn_affine": [p] * 4 + [i, q, i, i, i, p],
        # x, g, mean, inv, partial, c1, c2, N, S, C, G, dtype, device, stream
        "tpuseg_gn_bwd_reduce": [p] * 7 + [i, q, i, i, i, i, p],
        # x, g, A, C, D, dx, N, S, C, G, dtype, device, stream
        "tpuseg_gn_bwd_dx": [p] * 6 + [i, q, i, i, i, i, p],
        # x, w, a, b, y, N, D, H, W, Ci, Co, KD, pre_relu, post_relu, dtype,
        # device, stream
        "tpuseg_gcr_conv3d_forward": [p] * 5 + [i] * 11 + [p],
        # acc, cnt, patches, starts, weights (host), P, pd, ph, pw, C, the
        # patch strides sb, sz, sy, sx, sc, D, H, W, z0, y0, x0, bz, by, bx,
        # dtype, device, stream
        "tpuseg_overlap_add": [p] * 5 + [i] * 5 + [q] * 5 + [i] * 11 + [p],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = i
    lib.tpuseg_cuda_error_string.argtypes = [i]
    lib.tpuseg_cuda_error_string.restype = ctypes.c_char_p


def load() -> ctypes.CDLL:
    """The kernel library, built on the first call of the process."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            _declare(lib)
            _lib = lib
        return _lib


HOST_CC_FLAGS = ("-O2", "-shared", "-fPIC")
_host_libs: dict = {}


def find_cc() -> str:
    """Path of the host C compiler (``cc``, else ``gcc``; the machine with
    the card has the one nvcc uses).  Raises if there is none."""
    for name in ("cc", "gcc"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError(
        "no C compiler found (cc or gcc on PATH): the port's host C code "
        "(csrc/*.c, such as the PNG decoder's unfilter) is built from source "
        "at first use")


def host_library_path(source: str) -> Path:
    """Where ``csrc/<source>`` is built: ``BUILD_DIR``, named by a hash of
    the flags and the source."""
    h = hashlib.sha256(" ".join(HOST_CC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def host_library(source: str) -> ctypes.CDLL:
    """``csrc/<source>`` (plain C) compiled with the host C compiler into a
    shared library on the first call of the process, then loaded; the same
    temporary-file-and-rename as the kernel library."""
    with _lock:
        lib = _host_libs.get(source)
        if lib is None:
            path = host_library_path(source)
            if not path.exists():
                path.parent.mkdir(parents=True, exist_ok=True)
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                cmd = [find_cc(), *HOST_CC_FLAGS, "-o", str(tmp),
                       str(CSRC / source)]
                rcs, log = _run_all([cmd])
                if rcs[0]:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"cc failed (rc {rcs[0]}):\n{log}")
                os.replace(tmp, path)
            lib = _host_libs[source] = ctypes.CDLL(str(path))
        return lib


def kernel(name: str):
    """The library's C function ``name``; after the first call no lock and
    no lookup beyond an attribute read (the wrappers' hot path)."""
    return getattr(_lib if _lib is not None else load(), name)


def current_stream(device_index: int) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device, without
    building a ``torch.cuda.Stream`` object (the handle PyTorch's own
    generated kernels launch on)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        msg = load().tpuseg_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
