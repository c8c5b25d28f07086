"""Build and bind the hand-written CUDA kernels under ``csrc/``.

nvcc compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source,
in parallel) into one shared library with a plain C interface, ``gravo_mg_tpu_torch/_build/libgravomg_cuda.so``,
at first CUDA use and again whenever a ``.cu`` or ``.cuh`` source is newer
than the library: the SpMV kernels, and the fused loop's WHILE graph
(``graph_loop.cu``).  The library is loaded with ctypes: every pointer,
graph handle and the stream go over as ``c_void_p``, sizes as
``c_int64``, the Chebyshev coefficients as ``c_double``, and each entry
point returns ``cudaGetLastError()`` or the error of the call that
failed, which :func:`check` turns into an
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
_P = ctypes.c_void_p
_I = ctypes.c_int64
_D = ctypes.c_double
# sliced_spmv: (slice_ptr, col, val, x, y[, epilogue vectors, row mask],
# nrows, d, tpr[, first, c1, c2], stream); sliced_diag_spmv: (slice_ptr,
# base, delta, val, wide_ptr, wide_col, x, y[, epilogue vectors, row mask],
# nrows, d[, first, c1, c2], stream); halo_spmv: (slice_ptr, col, val,
# out_row, halo, y[, epilogue vectors], nrows, d, tpr[, first, c1, c2],
# stream).  The residual and add epilogues take one vector (b or z), the
# Chebyshev step three (b, dinv, d), on halo_spmv four (x, b, dinv, d).
_SLICED_ARGS = [_P] * 5 + [_I] * 3 + [_P]
_SLICED_VEC_ARGS = [_P] * 7 + [_I] * 3 + [_P]
_SLICED_CHEB_ARGS = [_P] * 9 + [_I] * 4 + [_D] * 2 + [_P]
_SLICED_DIAG_ARGS = [_P] * 8 + [_I] * 2 + [_P]
_SLICED_DIAG_VEC_ARGS = [_P] * 10 + [_I] * 2 + [_P]
_SLICED_DIAG_CHEB_ARGS = [_P] * 12 + [_I] * 3 + [_D] * 2 + [_P]
_HALO_ARGS = [_P] * 6 + [_I] * 3 + [_P]
_HALO_VEC_ARGS = [_P] * 7 + [_I] * 3 + [_P]
_HALO_CHEB_ARGS = [_P] * 10 + [_I] * 4 + [_D] * 2 + [_P]
_SIGNATURES = {
    "gravomg_graph_node_types": [_P, ctypes.POINTER(ctypes.c_int64)],
    "gravomg_graph_loop_create": [_P, _P, ctypes.POINTER(_P), ctypes.POINTER(_P),
                                  ctypes.POINTER(ctypes.c_int64)],
    "gravomg_graph_loop_launch": [_P, _P],
    "gravomg_graph_loop_destroy": [_P, _P],
    "gravomg_halo_spmv_f32": _HALO_ARGS,
    "gravomg_halo_spmv_f64": _HALO_ARGS,
    "gravomg_halo_spmv_residual_f32": _HALO_VEC_ARGS,
    "gravomg_halo_spmv_residual_f64": _HALO_VEC_ARGS,
    "gravomg_halo_spmv_add_f32": _HALO_VEC_ARGS,
    "gravomg_halo_spmv_add_f64": _HALO_VEC_ARGS,
    "gravomg_halo_spmv_cheb_f32": _HALO_CHEB_ARGS,
    "gravomg_halo_spmv_cheb_f64": _HALO_CHEB_ARGS,
    "gravomg_sliced_diag_spmv_f32": _SLICED_DIAG_ARGS,
    "gravomg_sliced_diag_spmv_f64": _SLICED_DIAG_ARGS,
    "gravomg_sliced_diag_spmv_residual_f32": _SLICED_DIAG_VEC_ARGS,
    "gravomg_sliced_diag_spmv_residual_f64": _SLICED_DIAG_VEC_ARGS,
    "gravomg_sliced_diag_spmv_cheb_f32": _SLICED_DIAG_CHEB_ARGS,
    "gravomg_sliced_diag_spmv_cheb_f64": _SLICED_DIAG_CHEB_ARGS,
    "gravomg_shuffle_spmv_f32": _SPMV_ARGS,
    "gravomg_shuffle_spmv_f64": _SPMV_ARGS,
    "gravomg_diag_spmv_f32": _DIAG_ARGS,
    "gravomg_diag_spmv_f64": _DIAG_ARGS,
    "gravomg_sliced_spmv_f32": _SLICED_ARGS,
    "gravomg_sliced_spmv_f64": _SLICED_ARGS,
    "gravomg_sliced_spmv_residual_f32": _SLICED_VEC_ARGS,
    "gravomg_sliced_spmv_residual_f64": _SLICED_VEC_ARGS,
    "gravomg_sliced_spmv_add_f32": _SLICED_VEC_ARGS,
    "gravomg_sliced_spmv_add_f64": _SLICED_VEC_ARGS,
    "gravomg_sliced_spmv_cheb_f32": _SLICED_CHEB_ARGS,
    "gravomg_sliced_spmv_cheb_f64": _SLICED_CHEB_ARGS,
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
    """Compile every ``csrc/*.cu`` into the library, unconditionally: one
    nvcc per source, all started together, then one link."""
    global build_log
    cu, _ = _sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f".{p.stem}.{tag}.o" for p in cu]
    cmds = [
        [nvcc, "-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17",
         "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c", str(p),
         "-o", str(o)]
        for p, o in zip(cu, objs)
    ]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    logs, failed = [], False
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate(timeout=900)
        logs.append(" ".join(cmd) + "\n" + out)
        failed |= proc.returncode != 0
    tmp = BUILD_DIR / f".{LIBRARY.name}.{tag}"
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *[str(o) for o in objs]]
        res = subprocess.run(link, capture_output=True, text=True, timeout=300)
        logs.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        failed = res.returncode != 0
    for o in objs:
        o.unlink(missing_ok=True)
    build_log = "\n".join(logs)
    if failed:
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
