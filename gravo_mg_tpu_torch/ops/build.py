"""Build and bind the hand-written CUDA kernels under ``csrc/``.

nvcc compiles every ``csrc/*.cu`` for ``sm_90a`` into one shared library
with a plain C interface, ``gravo_mg_tpu_torch/_build/libgravomg_cuda.so``,
at first CUDA use and again whenever a ``.cu`` or ``.cuh`` source is newer
than the library.  The library is loaded with ctypes: every pointer and
the stream go over as ``c_void_p``, sizes as ``c_int64``, and each entry
point returns ``cudaGetLastError()``, which :func:`check` turns into an
exception.  Nothing here runs at import time, so the package imports on
machines without nvcc or a GPU.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIBRARY = BUILD_DIR / "libgravomg_cuda.so"
ARCH = "sm_90a"

_SPMV_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
_DIAG_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 6 + [ctypes.c_void_p]
_SIGNATURES = {
    "gravomg_shuffle_spmv_f32": _SPMV_ARGS,
    "gravomg_shuffle_spmv_f64": _SPMV_ARGS,
    "gravomg_diag_spmv_f32": _DIAG_ARGS,
    "gravomg_diag_spmv_f64": _DIAG_ARGS,
}

_lib = None
_lock = threading.Lock()
build_log = ""   # nvcc's output (ptxas register/spill report) of the last build


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or "",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _stale() -> bool:
    if not LIBRARY.exists():
        return True
    built = LIBRARY.stat().st_mtime
    cu, cuh = _sources()
    return any(built < p.stat().st_mtime for p in cu + cuh)


def build_library() -> None:
    """Compile every ``csrc/*.cu`` into the library, unconditionally."""
    global build_log
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{LIBRARY.name}.{os.getpid()}"
    cmd = [
        _nvcc(), "-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *[str(p) for p in cu], "-o", str(tmp),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    build_log = " ".join(cmd) + "\n" + res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc build failed:\n{build_log[-6000:]}")
    os.replace(tmp, LIBRARY)


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if _stale():
            build_library()
        lib = ctypes.CDLL(str(LIBRARY))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.gravomg_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gravomg_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = lib.gravomg_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
