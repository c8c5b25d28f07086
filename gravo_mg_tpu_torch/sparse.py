"""Sparse containers and host-built slot layouts.

Counterpart of ``gravo_mg_tpu/sparse.py``.  The host half (slot layouts,
plan arrays, prolongation assembly) is numpy over the native C++ kernels
and produces the same arrays as the reference.  The device half is plain
dataclasses of torch tensors with a ``.to(device)``:

* :class:`ShuffleEll` — per (slot, 128-row group) one source block ``q``
  plus a per-row lane ``r``; applied by ``ops/shuffle_spmv.py``;
* :class:`DiagEll` — the source block is an arithmetic run within tiles
  of ``tg`` groups (``start`` table); applied by ``ops/diag_spmv.py``;
* :class:`EllMatrix` — transposed padded rows, the planner's fallback for
  padding-pathological operators (plain torch gather);
* :class:`ShuffleTransfer` / :class:`Prolongation` — grid transfers.

All SpMVs take x of shape (N,) or (N, d) in one call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .ops.diag_spmv import diag_spmv as _diag_kernel
from .ops.shuffle_spmv import shuffle_spmv as _shuffle_kernel


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch floating dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


@dataclasses.dataclass
class EllMatrix:
    """Padded-row sparse matrix, transposed layout: (K, N) slot-major."""

    indices: torch.Tensor   # (K, N) int64, padding = 0
    values: torch.Tensor    # (K, N), padding = 0
    ncols: int

    @property
    def shape(self):
        return (self.indices.shape[1], self.ncols)

    def to(self, device) -> "EllMatrix":
        return dataclasses.replace(
            self, indices=self.indices.to(device), values=self.values.to(device)
        )


def ell_spmv(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    vals = A.values if x.ndim == 1 else A.values[..., None]
    return (vals * x[A.indices]).sum(0)


@dataclasses.dataclass
class ShuffleEll:
    """Sparse matrix in shuffle-ELL layout: within each group of 128
    consecutive output rows, slot k sources from the single 128-aligned
    block ``q[k, g]`` of x, and ``r[k, g, l]`` selects the lane."""

    q: torch.Tensor   # (KP, S) int32 — source block per (slot, row group)
    r: torch.Tensor   # (KP, S, 128) int8 — lane within block (0..127)
    v: torch.Tensor   # (KP, S, 128) — values (0 = padding)
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def to(self, device) -> "ShuffleEll":
        return dataclasses.replace(
            self, q=self.q.to(device), r=self.r.to(device), v=self.v.to(device)
        )


@dataclasses.dataclass
class DiagEll:
    """Sparse matrix in diagonal-run layout: block(k, g0+s) =
    start[tile, k] - tg + s within each tile of ``tg`` row groups."""

    start: torch.Tensor  # (n_tiles, KP) int32 — g0 + d + tg per slot
    r: torch.Tensor      # (KP, S_pad, 128) int8 — lane within block
    v: torch.Tensor      # (KP, S_pad, 128) — values (0 = padding)
    tg: int
    nrows: int
    ncols: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def to(self, device) -> "DiagEll":
        return dataclasses.replace(
            self, start=self.start.to(device), r=self.r.to(device),
            v=self.v.to(device),
        )


def _check_cols(A, x):
    if x.shape[0] != A.ncols:
        raise ValueError(f"x has {x.shape[0]} rows, operator has {A.ncols} columns")


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape (N,) or (N, d), dispatched on the layout."""
    _check_cols(A, x)
    if isinstance(A, ShuffleEll):
        return _shuffle_kernel(A.q, A.r, A.v, x, A.nrows)
    if isinstance(A, DiagEll):
        return _diag_kernel(A.start, A.r, A.v, x, A.tg, A.nrows)
    return ell_spmv(A, x)


def _shuffle_layout(rows: np.ndarray, cols: np.ndarray, nr: int, nc: int,
                    kc: int = 4):
    """Host-side slot assignment for shuffle-ELL (see ShuffleEll).

    Returns (KP, S, q, flat_pos): ``q`` the (KP, S) block table and
    ``flat_pos[p]`` the destination of input nnz p inside the flattened
    (KP, S, 128) value/lane arrays.  Duplicate (row, col) pairs get
    distinct slots (COO summation semantics).  KP is padded to a multiple
    of ``kc`` and S to a multiple of 8, as in the reference.
    """
    from .native import shuffle_layout as native_layout

    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    S = max(-(-nr // 128), 1)
    S += (-S) % 8
    if rows.size == 0:
        return kc, S, np.zeros((kc, S), np.int32), np.zeros((0,), np.int64)
    kp_cap = int(np.bincount(rows >> 7).max())  # kp <= max nnz per group
    kp, q, flat_pos = native_layout(rows, cols, S, kc, kp_cap)
    return kp, S, q, flat_pos


def shuffle_from_scipy(A, dtype=torch.float32,
                       size_cap: int | None = None) -> ShuffleEll | None:
    """Convert any scipy sparse matrix to shuffle-ELL (host tensors).

    ``size_cap``: if the layout would pad beyond this many elements,
    return None without materializing the padded arrays; callers fall
    back to the gather/index_add form.
    """
    A = A.tocoo()
    A.sum_duplicates()
    nr, nc = A.shape
    npdt = numpy_dtype(dtype)
    # Diagonal fast path (mass matrices): slot 0 of group g sources block
    # g with lane == row lane — no sort needed.
    if (nr == nc and A.nnz == nr
            and np.array_equal(A.row, A.col)
            and np.array_equal(A.row, np.arange(nr))):
        s = max(-(-nr // 128), 1)
        s += (-s) % 8
        kc = 4
        q = np.zeros((kc, s), np.int32)
        q[0, : -(-nr // 128)] = np.arange(-(-nr // 128), dtype=np.int32)
        r = np.zeros((kc, s, 128), np.int8)
        r[0] = np.arange(128, dtype=np.int8)[None, :]
        v = np.zeros((kc, s, 128), npdt)
        v.reshape(kc, -1)[0, :nr] = A.data
        return ShuffleEll(_tensor(q), _tensor(r), _tensor(v), nr, nc)
    kp, s, q, pos = _shuffle_layout(A.row, A.col, nr, nc)
    padded = kp * s * 128
    if size_cap is not None and padded > size_cap:
        return None
    # lanes 0..127 fit int8; values are staged directly in the target dtype
    r = np.zeros((padded,), np.int8)
    v = np.zeros((padded,), npdt)
    r[pos] = (np.asarray(A.col, np.int64) & 127).astype(np.int8)
    v[pos] = A.data
    return ShuffleEll(
        _tensor(q), _tensor(r.reshape(kp, s, 128)),
        _tensor(v.reshape(kp, s, 128)), nr, nc,
    )


def _pick_tg(s_groups: int) -> int:
    """Tile size (row groups) of the diag layout, as in the reference."""
    if s_groups >= 4096:
        return 512
    if s_groups >= 512:
        return 128
    return 32


def _diag_layout(rows: np.ndarray, cols: np.ndarray, nr: int, nc: int,
                 kc: int = 4, tg: int | None = None):
    """Host-side diagonal-run slot assignment (see DiagEll).

    Returns (kp, S_pad, tg, start_tbl (n_tiles, kp) i32, flat_pos):
    ``flat_pos[p]`` is the destination of nnz p in the flattened
    (KP, S_pad, 128) arrays.  Slots are allocated per (tile, block
    diagonal) with occupancy = max (group, lane) multiplicity.
    """
    from .native import diag_layout as native_diag

    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    S = max(-(-nr // 128), 1)
    if tg is None:
        tg = _pick_tg(S)
    S_pad = S + (-S) % tg
    n_tiles = S_pad // tg
    if rows.size == 0:
        start = np.full((n_tiles, kc), tg, np.int32)
        return kc, S_pad, tg, start, np.zeros((0,), np.int64)
    # kp_tile = sum_d maxmult(tile, d) <= nnz in the tile.
    kp_cap = int(np.bincount(rows // (128 * tg), minlength=1).max())
    kp, start, flat_pos = native_diag(rows, cols, S_pad, tg, kc, kp_cap)
    return kp, S_pad, tg, start, flat_pos


def _pattern_coo(idx: np.ndarray, mask: np.ndarray):
    """(ell_pos, rows, cols) of the real entries of a (K, N) ELL pattern."""
    idx = np.asarray(idx)
    mask = np.asarray(mask, dtype=bool).reshape(-1)
    k, n = idx.shape
    ell_pos = np.arange(k * n, dtype=np.int64)[mask]
    rows = np.tile(np.arange(n, dtype=np.int64), (k, 1)).reshape(-1)[mask]
    cols = idx.reshape(-1)[mask].astype(np.int64)
    return ell_pos, rows, cols


def diag_plan_arrays(idx: np.ndarray, mask: np.ndarray, ncols: int):
    """Diag-run layout of a transposed-ELL pattern (host numpy).

    Returns (start (n_tiles, KP) i32, tg, r (KP, S, 128) int8,
    src (KP, S, 128) i32) with ``src`` indexing the flattened (K*N,)
    ELL values (K*N = padding, routed to an appended zero)."""
    k, n = np.asarray(idx).shape
    ell_pos, rows, cols = _pattern_coo(idx, mask)
    kp, s_pad, tg, start, pos = _diag_layout(rows, cols, n, ncols)
    r = np.zeros((kp * s_pad * 128,), np.int8)  # lanes 0..127
    src = np.full((kp * s_pad * 128,), k * n, np.int32)
    r[pos] = cols & 127
    src[pos] = ell_pos
    return start, tg, r.reshape(kp, s_pad, 128), src.reshape(kp, s_pad, 128)


def shuffle_plan_arrays(idx: np.ndarray, mask: np.ndarray, ncols: int):
    """Shuffle layout of a transposed-ELL pattern (host numpy).

    ``idx (K, N)`` column indices, ``mask (K, N)`` real-vs-padding.
    Returns ``(q (KP, S) i32, r (KP, S, 128) int8, src (KP, S, 128) i32)``
    where ``src`` indexes the flattened (K*N,) ELL values, with K*N
    meaning padding (route to an appended zero).
    """
    k, n = np.asarray(idx).shape
    ell_pos, rows, cols = _pattern_coo(idx, mask)
    kp, s, q, pos = _shuffle_layout(rows, cols, n, ncols)
    r = np.zeros((kp * s * 128,), np.int8)  # lanes 0..127
    src = np.full((kp * s * 128,), k * n, np.int32)
    r[pos] = cols & 127
    src[pos] = ell_pos
    return q, r.reshape(kp, s, 128), src.reshape(kp, s, 128)


@dataclasses.dataclass
class ShuffleTransfer:
    """Grid-transfer pair in shuffle-ELL form: U (prolong) and U^T
    (restrict), both gather-formulated SpMVs."""

    U: ShuffleEll
    UT: ShuffleEll

    @property
    def ncoarse(self):
        return self.U.ncols

    def prolong(self, e):
        return spmv(self.U, e)

    def restrict(self, r):
        return spmv(self.UT, r)

    def to(self, device) -> "ShuffleTransfer":
        return ShuffleTransfer(self.U.to(device), self.UT.to(device))


@dataclasses.dataclass
class Prolongation:
    """Sparse prolongation U, fixed row width W, transposed (W, Nf) layout.

      prolong(e):  x = sum_w weights[w] * e[cols[w]]     (gather)
      restrict(r): U^T r by ``index_add_`` into the coarse rows

    ``host_cols``/``host_weights`` are numpy mirrors (as built) so that
    setup-time ``to_scipy`` never reads the device.
    """

    cols: torch.Tensor       # (W, Nf) int64
    weights: torch.Tensor    # (W, Nf)
    ncoarse: int
    host_cols: np.ndarray    # (W, Nf) int32
    host_weights: np.ndarray  # (W, Nf)

    @property
    def shape(self):
        return (self.cols.shape[1], self.ncoarse)

    def prolong(self, e: torch.Tensor) -> torch.Tensor:
        w = self.weights if e.ndim == 1 else self.weights[..., None]
        return (w * e[self.cols]).sum(0)

    def restrict(self, r: torch.Tensor) -> torch.Tensor:
        w = self.weights if r.ndim == 1 else self.weights[..., None]
        contrib = (w * r[None]).reshape((-1,) + tuple(r.shape[1:]))
        out = torch.zeros((self.ncoarse,) + tuple(r.shape[1:]),
                          dtype=r.dtype, device=r.device)
        return out.index_add_(0, self.cols.reshape(-1), contrib)

    def to(self, device, dtype=None) -> "Prolongation":
        return dataclasses.replace(
            self, cols=self.cols.to(device),
            weights=self.weights.to(device=device, dtype=dtype),
        )

    def to_scipy(self) -> sp.csr_matrix:
        w, nf = self.host_cols.shape
        rows = np.tile(np.arange(nf), w)
        m = sp.coo_matrix(
            (self.host_weights.reshape(-1).astype(np.float64),
             (rows, self.host_cols.reshape(-1))),
            shape=(nf, self.ncoarse),
        )
        m.sum_duplicates()
        return m.tocsr()


def make_prolongation(cols: np.ndarray, weights: np.ndarray, ncoarse: int,
                      dtype=torch.float32) -> Prolongation:
    """Build a Prolongation on the host.

    ``cols``/``weights`` arrive row-major (Nf, W) from build_hierarchy
    and are transposed into the (W, Nf) layout here.
    """
    cols_t = np.ascontiguousarray(np.asarray(cols, dtype=np.int32).T)
    w_t = np.ascontiguousarray(np.asarray(weights).T)
    return Prolongation(
        _tensor(cols_t.astype(np.int64)),
        _tensor(w_t.astype(numpy_dtype(dtype))),
        int(ncoarse), cols_t, w_t,
    )
