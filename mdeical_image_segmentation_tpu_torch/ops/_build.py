"""Build the port's CUDA kernels at first use and load them with ctypes.

The sources under ``csrc/`` have a plain C interface, so ``nvcc`` compiles
them straight into a shared library in seconds (``torch.utils.cpp_extension``,
which compiles against PyTorch's headers, takes minutes).  The
library lands in ``build/torch_kernels/`` at the root of the checkout, named
by a hash of the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  It is written to a temporary file and renamed into
place, so two processes never load a half-written library.

Nothing here runs at import: ``load()`` builds and loads on the first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("double_conv2d.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
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


def nvcc_command(nvcc: str, out: Path) -> List[str]:
    return [nvcc, *NVCC_FLAGS, "-o", str(out),
            *(str(CSRC / s) for s in SOURCES)]


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in SOURCES:
        h.update(s.encode())
        h.update((CSRC / s).read_bytes())
    return BUILD_DIR / f"libtpuseg_kernels_{h.hexdigest()[:16]}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def _compile(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = nvcc_command(find_nvcc(), tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (rc {proc.returncode}):\n{log}")
    path.with_suffix(".log").write_text(log)
    os.replace(tmp, path)


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.tpuseg_double_conv2d_forward
    # x, w1, b1, w2, b2, y, z, N, H, W, Ci, C1, Co, dtype, device, stream
    fn.argtypes = [p] * 7 + [i] * 8 + [p]
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


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.tpuseg_cuda_error_string(rc).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
