"""Build and load the package's CUDA kernels and its host library.

Each source under `csrc/` is compiled into a shared library with a plain
C interface and loaded with `ctypes`: a `.cu` source with `nvcc` for
`sm_90a`, the host C++ of the native backend (`wva_queueing.cpp`, bound
by ops/native.py) with `g++`, the reference package's flags. The build
happens at first use, from the sources in the checkout, into
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
import time
from pathlib import Path

from ..obs.profile import DEVICE_AUDIT

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {"bisect_kernel": _PKG / "csrc" / "bisect_kernel.cu",
           "wva_queueing": _PKG / "csrc" / "wva_queueing.cpp"}
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

# bisect_kernel.cu launchers: (fcols, icols, clm, x_star, rows, clm_rows,
# k_max, trips, tail_pct, stream) -> cudaError_t
_BISECT = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
    ctypes.c_double, ctypes.c_void_p]


def _queueing_signatures() -> dict:
    """wva_queueing.cpp's C ABI (the reference package's ops/native.py)."""
    D, I = ctypes.c_double, ctypes.c_int32
    PD, PI = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32)
    return {
        "wva_analyze": ([D, D, D, D, I, I, I, I, D, PD], ctypes.c_int),
        "wva_size": ([D, D, D, D, I, I, I, I, D, D, D, PD], ctypes.c_int),
        "wva_size_batch": ([PD, PD, PD, PD, PI, PI, PI, PI, PD, PD, PD, I,
                            PD, PI], None),
        "wva_size_tail": ([D, D, D, D, I, I, I, I, D, D, D, D, PD],
                          ctypes.c_int),
        "wva_size_tail_batch": ([PD, PD, PD, PD, PI, PI, PI, PI, PD, PD, PD,
                                 D, I, PD, PI], None),
    }


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
    "wva_queueing": _queueing_signatures(),
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


def gxx_path() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found: the native host library cannot be "
                       "built on this host")


def compile_command(name: str, out: str) -> list[str]:
    """The compiler command that builds source `name` into `out`."""
    src = SOURCES[name]
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS, "-o", out, str(src)]
    return [gxx_path(), *GXX_FLAGS, "-o", out, str(src)]


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _compile(name: str) -> None:
    """Compile one source into a temporary file, then move it into place,
    so a reader never sees a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = compile_command(name, tmp)
    out = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    build_logs[name] = " ".join(cmd) + "\n" + out.stdout
    if out.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{os.path.basename(cmd[0])} failed for "
                           f"{name}:\n{out.stdout}")
    os.replace(tmp, library_path(name))


def _bind(path: Path, name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded library for one source, built first if needed. The
    first use in a process of a CUDA source counts as one compile of
    `name` in the device audit, with the seconds the build and load
    took (the host library is no device compile)."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            t0 = time.perf_counter()
            if not library_path(name).exists():
                _compile(name)
            lib = _loaded[name] = _bind(library_path(name), name)
            if SOURCES[name].suffix == ".cu":
                DEVICE_AUDIT.note_compile(name, time.perf_counter() - t0)
        return lib


def load_prebuilt(path: Path, name: str) -> ctypes.CDLL:
    """A library built elsewhere (the WVA_NATIVE_LIB override), bound to
    the signatures of source `name`; raises AttributeError when a symbol
    is missing (a library built from another source)."""
    return _bind(path, name)
