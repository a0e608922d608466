"""Build and load the package's CUDA kernels.

Each source under `csrc/` is compiled with `nvcc` for `sm_90a` into a
shared library with a plain C interface and loaded with `ctypes`. The
build happens at first use, from the sources in the checkout, into
`build/torch_kernels/` at the repository root; the library's file name
carries a hash of its source, so an edited source is rebuilt and an
unchanged one is loaded as it is.
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

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"bisect_kernel": _PKG / "csrc" / "bisect_kernel.cu"}
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# bisect_kernel.cu launchers: (fcols, icols, clm, x_star, rows, clm_rows,
# k_max, trips, tail_pct, stream) -> cudaError_t
_BISECT = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_double, ctypes.c_void_p]
SIGNATURES = {
    "bisect_kernel": {
        "wva_bisect_mean_f32": (_BISECT, ctypes.c_int),
        "wva_bisect_mean_f64": (_BISECT, ctypes.c_int),
        "wva_bisect_tail_f32": (_BISECT, ctypes.c_int),
        "wva_bisect_tail_f64": (_BISECT, ctypes.c_int),
        # (tail, f64, k_max) -> bytes, or -1 when k_max < 1
        "wva_bisect_smem_bytes": ([ctypes.c_int] * 3, ctypes.c_int),
        # (tail, f64, k_max, long_team, *blocks_per_sm) -> cudaError_t
        "wva_bisect_occupancy": ([ctypes.c_int] * 4
                                 + [ctypes.POINTER(ctypes.c_int)],
                                 ctypes.c_int),
        "wva_error_string": ([ctypes.c_int], ctypes.c_char_p),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# nvcc's output (with -Xptxas -v: registers, shared memory, spills) of
# each source built by this process
build_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidate = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda",
                             "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "on this host")


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name: str) -> None:
    """nvcc one source into a temporary file, then move it into place, so
    a reader never sees a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    out = subprocess.run(
        [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(SOURCES[name])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    build_logs[name] = out.stdout
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{out.stdout}")
    os.replace(tmp, library_path(name))


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            if not library_path(name).exists():
                _compile(name)
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _loaded[name] = lib
        return lib
