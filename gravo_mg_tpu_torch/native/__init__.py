"""ctypes loader for the native host-side setup kernels.

The C++ sources (``gravomg_native.cpp`` and ``ssp_native.cpp`` beside
this file) are byte-identical copies of the JAX package's
``gravo_mg_tpu/native/`` sources; the port builds only from its own
copies (``tests/test_torch_host.py`` holds them equal, so the two host
halves cannot drift).  The library is built with g++ on first use into
``gravo_mg_tpu_torch/_build/`` (rebuilt when a source is newer) and never
written next to the sources.  The loader never falls back on its own: if
the library cannot be built or loaded, it raises, and its message names
the device engine (``hierarchy_engine="device"``), which builds a
different hierarchy without this library only when the caller asks.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC_DIR = pathlib.Path(__file__).resolve().parent
SOURCES = [_SRC_DIR / "gravomg_native.cpp", _SRC_DIR / "ssp_native.cpp"]
_BUILD = _PKG / "_build"
_SO = _BUILD / "libgravomg_native.so"

_lib = None
_lock = threading.Lock()


def _build():
    missing = [str(s) for s in SOURCES if not s.exists()]
    if missing:
        raise RuntimeError(f"native sources not found: {missing}")
    _BUILD.mkdir(parents=True, exist_ok=True)
    # Build under per-process names and rename: concurrent test workers
    # may build at once, and a reader must never map a half-written file.
    # One compiler per source, all started together, then one link.
    tag = str(os.getpid())
    objs = [_BUILD / f".{s.stem}.{tag}.o" for s in SOURCES]
    tmp = _BUILD / f".{_SO.name}.{tag}"
    flags = ["-O3", "-fopenmp", "-fPIC", "-std=c++17"]
    cmds = [["g++", *flags, "-c", str(s), "-o", str(o)]
            for s, o in zip(SOURCES, objs)]
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        results = [(c, p.communicate(timeout=600)[0], p.returncode)
                   for c, p in zip(cmds, procs)]
        link = ["g++", "-fopenmp", "-shared", *map(str, objs), "-o", str(tmp)]
        if all(rc == 0 for _, _, rc in results):
            res = subprocess.run(link, capture_output=True, text=True, timeout=300)
            results.append((link, res.stdout + res.stderr, res.returncode))
        for cmd, out, rc in results:
            if rc != 0:
                raise RuntimeError(
                    f"native build failed ({' '.join(cmd)}):\n{out[-4000:]}"
                )
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, _SO)


def get_lib():
    """Load the native library, building it first if it is missing or
    older than a source."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            if not _SO.exists() or any(
                _SO.stat().st_mtime < s.stat().st_mtime for s in SOURCES
            ):
                _build()
            lib = ctypes.CDLL(str(_SO))
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            raise RuntimeError(
                f"the native library is unavailable ({exc}); to build the "
                "hierarchy without it, pass hierarchy_engine=\"device\" to "
                "MultigridSolver (engine=\"device\" to the hierarchy "
                "builders): it samples, clusters and weights in torch and "
                "gives a different hierarchy"
            ) from exc
        lib.unique_i64.restype = ctypes.c_int64
        lib.unique_i64.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
        lib.shuffle_layout.restype = ctypes.c_int64
        lib.shuffle_layout.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.diag_layout.restype = ctypes.c_int64
        lib.diag_layout.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.disk_sample.restype = None
        lib.disk_sample.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.disk_sample_ord.restype = None
        lib.disk_sample_ord.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.dijkstra_cluster.restype = None
        lib.dijkstra_cluster.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.fps_graph.restype = ctypes.c_int64
        lib.fps_graph.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
        ]
        lib.prolongation_weights_native.restype = None
        lib.prolongation_weights_native.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.ssp_decimate.restype = ctypes.c_int64
        lib.ssp_decimate.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
        return lib


def unique_i64(keys: np.ndarray) -> np.ndarray:
    """Sorted unique values of an int64 array."""
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    n = keys.shape[0]
    uniq = np.empty(max(n, 1), dtype=np.int64)
    m = lib.unique_i64(keys.ctypes.data, n, uniq.ctypes.data)
    return uniq[:m].copy()


def shuffle_layout(rows: np.ndarray, cols: np.ndarray, S: int, kc: int,
                   kp_cap: int):
    """(kp, q, flat_pos) shuffle-ELL slot assignment.

    ``q`` is returned as (kp, S) int32 (trimmed from the kp_cap capacity
    buffer); ``flat_pos`` as (nnz,) int64.
    """
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = rows.shape[0]
    kp_cap = max(int(kp_cap), int(kc))
    q = np.zeros((kp_cap, int(S)), dtype=np.int32)
    flat_pos = np.empty(nnz, dtype=np.int64)
    kp = lib.shuffle_layout(
        rows.ctypes.data, cols.ctypes.data, nnz, int(S), int(kc), kp_cap,
        q.ctypes.data, flat_pos.ctypes.data,
    )
    if kp < 0:
        raise RuntimeError(f"native shuffle_layout failed ({kp})")
    kp = int(kp)
    if kp > kp_cap:
        # The native kernel pads kp up to a multiple of kc, which may
        # exceed the true-slot capacity bound; the extra rows are zeros.
        q = np.concatenate([q, np.zeros((kp - kp_cap, int(S)), np.int32)])
        return kp, q, flat_pos
    return kp, q[:kp].copy(), flat_pos


def diag_layout(rows: np.ndarray, cols: np.ndarray, S_pad: int, tg: int,
                kc: int, kp_cap: int):
    """(kp, start, flat_pos) diagonal-run slot assignment.

    ``start`` is returned as (n_tiles, kp) int32 (pad slots hold ``tg``,
    trimmed from the kp_cap capacity buffer); ``flat_pos`` as (nnz,)
    int64 into the flattened (KP, S_pad, 128) arrays.
    """
    lib = get_lib()
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = rows.shape[0]
    kp_cap = max(int(kp_cap), int(kc))
    n_tiles = int(S_pad) // int(tg)
    start = np.full((n_tiles, kp_cap), int(tg), dtype=np.int32)
    flat_pos = np.empty(nnz, dtype=np.int64)
    kp = lib.diag_layout(
        rows.ctypes.data, cols.ctypes.data, nnz, int(S_pad), int(tg),
        int(kc), kp_cap, start.ctypes.data, flat_pos.ctypes.data,
    )
    if kp < 0:
        raise RuntimeError(f"native diag_layout failed ({kp})")
    kp = int(kp)
    if kp > kp_cap:
        start = np.concatenate(
            [start, np.full((n_tiles, kp - kp_cap), int(tg), np.int32)],
            axis=1,
        )
        return kp, start, flat_pos
    return kp, np.ascontiguousarray(start[:, :kp]), flat_pos


def disk_sample_native(neigh: np.ndarray, dist: np.ndarray, radius: float,
                       two_ring: bool, status: np.ndarray,
                       order: np.ndarray | None = None) -> None:
    """Greedy disk sampling, in place on ``status`` (int8, C-contiguous).
    ``order`` optionally sets the visit order (default: index order, the
    reference's sweep)."""
    lib = get_lib()
    neigh = np.ascontiguousarray(neigh, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    n, k = neigh.shape
    if status.dtype != np.int8 or not status.flags.c_contiguous:
        raise ValueError("status must be a C-contiguous int8 array")
    if order is None:
        lib.disk_sample(
            neigh.ctypes.data, dist.ctypes.data, n, k,
            ctypes.c_float(float(radius)), int(bool(two_ring)),
            status.ctypes.data,
        )
        return
    order = np.ascontiguousarray(order, dtype=np.int32)
    if order.shape != (n,):
        raise ValueError(f"order must have shape ({n},), got {order.shape}")
    lib.disk_sample_ord(
        neigh.ctypes.data, dist.ctypes.data, n, k,
        ctypes.c_float(float(radius)), int(bool(two_ring)),
        order.ctypes.data, status.ctypes.data,
    )


def dijkstra_cluster_native(neigh: np.ndarray, dist: np.ndarray,
                            samples: np.ndarray):
    """(labels, D) exact multi-source Dijkstra (label -1 = unreached)."""
    lib = get_lib()
    neigh = np.ascontiguousarray(neigh, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    n, k = neigh.shape
    label = np.empty(n, dtype=np.int32)
    D = np.empty(n, dtype=np.float32)
    lib.dijkstra_cluster(
        neigh.ctypes.data, dist.ctypes.data, n, k,
        samples.ctypes.data, samples.shape[0],
        label.ctypes.data, D.ctypes.data,
    )
    return label, D


def fps_graph_native(neigh: np.ndarray, dist: np.ndarray, target: int,
                     start: int = 0) -> np.ndarray:
    """Graph farthest-point sample indices (unsorted)."""
    lib = get_lib()
    neigh = np.ascontiguousarray(neigh, dtype=np.int32)
    dist = np.ascontiguousarray(dist, dtype=np.float32)
    n, k = neigh.shape
    target = min(int(target), n)
    samples = np.empty(max(target, 1), dtype=np.int32)
    m = lib.fps_graph(
        neigh.ctypes.data, dist.ctypes.data, n, k, target,
        np.int32(start), samples.ctypes.data,
    )
    return samples[:m].copy()


def ssp_decimate_native(V: np.ndarray, F: np.ndarray, target_nv: int,
                        dec_type: int):
    """Intrinsic-prolongation edge-collapse decimation (ssp_native.cpp).

    Returns ``(Vc, Fc, P_cols (nv,3) int64, P_w (nv,3) f64, alive bool)``:
    the coarse mesh plus per-fine-vertex coarse triangle corners and
    barycentric weights from the joint-LSCM collapse replay.  Raises on an
    empty mesh.
    """
    lib = get_lib()
    V = np.ascontiguousarray(V, dtype=np.float64)
    F = np.ascontiguousarray(F, dtype=np.int64)
    if V.ndim != 2 or V.shape[1] != 3 or F.ndim != 2 or F.shape[1] != 3:
        raise ValueError(f"ssp_decimate: V and F must be (n, 3), got "
                         f"{V.shape} and {F.shape}")
    nv, nf = V.shape[0], F.shape[0]
    if nf and (F.min() < 0 or F.max() >= nv):
        raise ValueError("ssp_decimate: face index out of range")
    Vc = np.empty((nv, 3), np.float64)
    Fc = np.empty((max(nf, 1), 3), np.int64)
    nfc = np.zeros(1, np.int64)
    P_cols = np.empty((nv, 3), np.int64)
    P_w = np.empty((nv, 3), np.float64)
    alive = np.empty(nv, np.int8)
    nc = lib.ssp_decimate(
        V.ctypes.data, nv, F.ctypes.data, nf, int(target_nv), int(dec_type),
        Vc.ctypes.data, Fc.ctypes.data, nfc.ctypes.data,
        P_cols.ctypes.data, P_w.ctypes.data, alive.ctypes.data,
    )
    if nc <= 0:
        raise ValueError(f"ssp_decimate: empty mesh ({nv} vertices, {nf} faces)")
    return (
        Vc[:nc].copy(), Fc[: int(nfc[0])].copy(), P_cols, P_w,
        alive.astype(bool),
    )


def prolongation_weights_cpp(fine_pos, labels, coarse_pos, coarse_neigh,
                             check_voronoi: bool, nested: bool, samples,
                             weighting: int):
    """(cols (n,3) i32, w (n,3) f32, stats (3,) i64): the OpenMP
    triangle-selection weight sweep (see hierarchy/prolongation.py)."""
    lib = get_lib()
    fine_pos = np.ascontiguousarray(fine_pos, dtype=np.float64)
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    coarse_pos = np.ascontiguousarray(coarse_pos, dtype=np.float64)
    coarse_neigh = np.ascontiguousarray(coarse_neigh, dtype=np.int32)
    n = fine_pos.shape[0]
    nc, kc = coarse_neigh.shape
    if samples is None:
        samples = np.full(nc, -1, dtype=np.int32)
    samples = np.ascontiguousarray(samples, dtype=np.int32)
    member_idx = np.argsort(labels, kind="stable").astype(np.int32)
    counts = np.bincount(labels, minlength=nc)
    member_start = np.zeros(nc + 1, dtype=np.int32)
    member_start[1:] = np.cumsum(counts)
    out_cols = np.empty((n, 3), dtype=np.int32)
    out_w = np.empty((n, 3), dtype=np.float32)
    stats = np.zeros(3, dtype=np.int64)
    lib.prolongation_weights_native(
        fine_pos.ctypes.data, n, labels.ctypes.data,
        coarse_pos.ctypes.data, nc, coarse_neigh.ctypes.data, kc,
        int(bool(check_voronoi)), int(bool(nested)), samples.ctypes.data,
        member_start.ctypes.data, member_idx.ctypes.data,
        int(weighting), out_cols.ctypes.data, out_w.ctypes.data,
        stats.ctypes.data,
    )
    return out_cols, out_w, stats
