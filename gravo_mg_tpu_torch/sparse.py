"""Sparse containers and host-built slot layouts.

Counterpart of ``gravo_mg_tpu/sparse.py``.  The host half (slot layouts,
plan arrays, prolongation assembly) is numpy over the native C++ kernels
and produces the same arrays as the reference, where the reference has
the layout (SlicedEll is the port's own).  The device half is plain
dataclasses of torch tensors with a ``.to(device)``:

* :class:`SlicedEll` — rows in slices of 32, each slice as wide as its
  longest row, column and value per entry; applied by
  ``ops/sliced_spmv.py``;
* :class:`SlicedDiag` — the same slices, with a column implied by the
  row: one int32 base per (slice, slot) and an int8 delta per entry
  (int32 columns for the slices whose deltas do not fit); the layout of
  a large level operator (and of CG's operator) where it streams fewer
  bytes than SlicedEll; applied by ``ops/sliced_diag_spmv.py``;
* :class:`ShuffleEll` — per (slot, 128-row group) one source block ``q``
  plus a per-row lane ``r`` (the JAX package's TPU layout, carried over
  by ``convert.py``; no solve builds it); applied by
  ``ops/shuffle_spmv.py``;
* :class:`DiagEll` — the source block is an arithmetic run within tiles
  of ``tg`` groups (``start`` table; the JAX package's TPU layout, carried
  over by ``convert.py``); applied by ``ops/diag_spmv.py``;
* :class:`EllMatrix` — transposed padded rows (the JAX package's layout,
  carried over by ``convert.py``; no solve builds it; plain torch gather);
* :class:`ShuffleTransfer` / :class:`Prolongation` — grid transfers.

All SpMVs take x of shape (N,) or (N, d) in one call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from .ops import sliced_diag_spmv as _sdiag
from .ops import sliced_spmv as _sliced
from .ops.diag_spmv import diag_spmv as _diag_kernel
from .ops.epilogue import epilogue_plain
from .ops.shuffle_spmv import shuffle_spmv as _shuffle_kernel
from .ops.sliced_spmv import SLICE


def numpy_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy dtype of a torch floating dtype."""
    return torch.empty((), dtype=dtype).numpy().dtype


def resolve_device(device) -> torch.device:
    """The torch device to run on; CUDA must really be there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path explicitly"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


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


def ell_from_scipy(A, dtype=torch.float32) -> EllMatrix:
    """Convert any scipy sparse matrix to transposed ELL (host tensors)."""
    A = A.tocsr()
    A.sum_duplicates()
    n, m = A.shape
    degree = np.diff(A.indptr)
    k = max(int(degree.max()) if n else 1, 1)
    indices = np.zeros((k, n), dtype=np.int64)
    values = np.zeros((k, n), dtype=numpy_dtype(dtype))
    slot = np.arange(A.indices.shape[0]) - np.repeat(A.indptr[:-1], degree)
    row_ids = np.repeat(np.arange(n), degree)
    indices[slot, row_ids] = A.indices
    values[slot, row_ids] = A.data
    return EllMatrix(_tensor(indices), _tensor(values), m)


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


@dataclasses.dataclass
class SlicedEll:
    """Sparse matrix in sliced-ELL layout (SELL-32): rows in slices of 32
    (one warp on the card); slice ``s`` is ``w_s`` slots wide, ``w_s`` its
    largest row degree, and entry (s, k, lane) of row ``32 s + lane``
    sits at ``slice_ptr[s] + 32 k + lane``.  A row's entries keep their
    CSR column order; padding has weight 0 and column 0.  ``tpr``
    (threads per row on the card, a power of two up to 32) is chosen once
    per operator by :func:`pick_tpr`."""

    slice_ptr: torch.Tensor  # (n_slices + 1,) int64 entry offsets
    col: torch.Tensor        # (E,) int32 column (padding: 0)
    val: torch.Tensor        # (E,) values (padding: 0)
    nrows: int
    ncols: int
    nnz: int
    tpr: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def to(self, device) -> "SlicedEll":
        return dataclasses.replace(
            self, slice_ptr=self.slice_ptr.to(device), col=self.col.to(device),
            val=self.val.to(device),
        )

    def info(self) -> dict:
        """Rows, slices, stored entries, nonzeros, padding factor
        (entries / nnz), widest slice, threads per row and the bytes one
        apply streams at d = 1 (:func:`sliced_bytes` plus x and y)."""
        ptr = self.slice_ptr.cpu()
        widths = torch.diff(ptr) // SLICE
        entries = int(self.col.numel())
        item = self.val.element_size()
        return {
            "rows": self.nrows, "slices": int(widths.numel()),
            "entries": entries, "nnz": self.nnz,
            "padding": entries / max(self.nnz, 1),
            "max_width": int(widths.max()) if widths.numel() else 0,
            "threads_per_row": self.tpr,
            "bytes": sliced_bytes(ptr.numpy(), item) + (self.nrows + self.ncols) * item,
        }


@dataclasses.dataclass
class SlicedDiag:
    """Sparse matrix in sliced diagonal-run layout: the slices of
    :class:`SlicedEll` (entry (s, k, lane) of row ``32 s + lane`` at ``e =
    slice_ptr[s] + 32 k + lane``), each column implied by its row,

        col = 32 s + lane + base[slice_ptr[s] / 32 + k] + delta[e],

    with one int32 ``base`` per (slice, slot) and one int8 ``delta`` per
    entry: a run of rows reading one diagonal, the idea of :class:`DiagEll`
    at the width of a warp.  A slice whose deltas do not fit int8, or whose
    padding cannot reach a column in range, is *wide*: ``wide_ptr[s] >= 0``
    and its columns are ``wide_col[wide_ptr[s] + e - slice_ptr[s]]`` (its
    base and delta entries are 0 and never read).  Padding has weight 0 and
    a column in [0, ncols); a row's entries keep their CSR column order.
    ``wmax`` is the widest slice in slots."""

    slice_ptr: torch.Tensor  # (n_slices + 1,) int64 entry offsets
    base: torch.Tensor       # (E / 32,) int32, one per (slice, slot)
    delta: torch.Tensor      # (E,) int8 column minus row minus base
    val: torch.Tensor        # (E,) values (padding: 0)
    wide_ptr: torch.Tensor   # (n_slices,) int64 offset into wide_col, or -1
    wide_col: torch.Tensor   # (E_wide,) int32 columns of the wide slices
    nrows: int
    ncols: int
    nnz: int
    wmax: int

    @property
    def shape(self):
        return (self.nrows, self.ncols)

    def to(self, device) -> "SlicedDiag":
        return dataclasses.replace(
            self, slice_ptr=self.slice_ptr.to(device), base=self.base.to(device),
            delta=self.delta.to(device), val=self.val.to(device),
            wide_ptr=self.wide_ptr.to(device), wide_col=self.wide_col.to(device),
        )

    def info(self) -> dict:
        """Rows, slices, wide slices, stored entries, nonzeros, padding
        factor (entries / nnz), widest slice and the bytes one apply
        streams at d = 1 (:func:`sliced_diag_bytes` plus x and y)."""
        ptr = self.slice_ptr.cpu().numpy()
        wide_ptr = self.wide_ptr.cpu().numpy()
        entries = int(self.delta.numel())
        item = self.val.element_size()
        return {
            "rows": self.nrows, "slices": int(wide_ptr.size),
            "wide_slices": int((wide_ptr >= 0).sum()),
            "entries": entries, "nnz": self.nnz,
            "padding": entries / max(self.nnz, 1),
            "max_width": self.wmax,
            "bytes": sliced_diag_bytes(ptr, wide_ptr, item)
            + (self.nrows + self.ncols) * item,
        }


# pick_tpr's targets: the fewest threads a launch should have, and the
# most slots a thread should walk on average (H100 sweeps of the 1M
# Poisson operators, PERF.md).
TPR_THREADS = 1 << 16
TPR_SLOTS = 32


def pick_tpr(slice_ptr: np.ndarray, nrows: int) -> int:
    """Threads per row for a SlicedEll: doubled from 1 (up to 32) while the
    launch has fewer than ``TPR_THREADS`` threads or a thread would walk
    more than ``TPR_SLOTS`` slots on average, until a row's threads cover
    the widest slice."""
    slice_ptr = np.asarray(slice_ptr)
    widths = np.diff(slice_ptr) // SLICE
    wmax = int(widths.max()) if widths.size else 0
    slots = int(slice_ptr[-1]) // SLICE if slice_ptr.size else 0   # over slices
    t = 1
    while t < SLICE and t < wmax and (nrows * t < TPR_THREADS
                                      or slots > TPR_SLOTS * t * widths.size):
        t *= 2
    return t


def _sliced_layout(indptr: np.ndarray, nrows: int):
    """Slice offsets and entry destinations of a CSR row pattern.

    Returns ``(slice_ptr (n_slices + 1,) int64, dest (nnz,) int64)``:
    the ``j``-th entry of row ``i`` goes to ``slice_ptr[i // 32] + 32 j +
    i % 32``."""
    indptr = np.asarray(indptr, dtype=np.int64)
    deg = np.diff(indptr)
    n_slices = -(-nrows // SLICE)
    padded = np.zeros(n_slices * SLICE, np.int64)
    padded[:nrows] = deg
    width = padded.reshape(n_slices, SLICE).max(axis=1, initial=0)
    slice_ptr = np.zeros(n_slices + 1, np.int64)
    np.cumsum(width * SLICE, out=slice_ptr[1:])
    row = np.repeat(np.arange(nrows, dtype=np.int64), deg)
    j = np.arange(indptr[-1], dtype=np.int64) - indptr[row]
    dest = slice_ptr[row // SLICE] + j * SLICE + row % SLICE
    return slice_ptr, dest


def sliced_pattern(A):
    """The SlicedEll pattern of a canonical csr matrix (sorted, no
    duplicates); every sliced layout of the port is built through it.

    Returns ``(slice_ptr (n_slices + 1,) int64, col (E,) int32, pos
    (E,))``: ``pos[e]`` is the csr data position entry ``e`` holds, and
    ``nnz`` marks padding (column 0), so ``append(A.data, 0)[pos]`` are
    the layout's values.  ``pos`` is int32 where ``nnz < 2**31``, else
    int64."""
    slice_ptr, dest = _sliced_layout(A.indptr, A.shape[0])
    nnz = int(A.nnz)
    col = np.zeros(int(slice_ptr[-1]), np.int32)
    col[dest] = A.indices
    pos = np.full(col.size, nnz, np.int32 if nnz < 2**31 else np.int64)
    pos[dest] = np.arange(nnz, dtype=pos.dtype)
    return slice_ptr, col, pos


def _sliced_entries(A, dtype, size_cap: int | None = None):
    """(canonical csr A, slice_ptr, col, val, real) of A's SlicedEll
    layout, ``real`` marking the entries that hold a nonzero; None where
    the layout would store more than ``size_cap`` entries."""
    A = A.tocsr()
    if not A.has_canonical_format:
        A = A.copy()
        A.sum_duplicates()
    slice_ptr, col, pos = sliced_pattern(A)
    if size_cap is not None and col.size > size_cap:
        return None
    val = np.append(A.data, 0).astype(numpy_dtype(dtype), copy=False)[pos]
    return A, slice_ptr, col, val, pos != A.nnz


def sliced_from_scipy(A, dtype=torch.float32,
                      size_cap: int | None = None) -> SlicedEll | None:
    """Convert any scipy sparse matrix to SlicedEll (host tensors);
    duplicates are summed.  ``size_cap``: if the layout would store more
    than this many entries, return None."""
    got = _sliced_entries(A, dtype, size_cap)
    if got is None:
        return None
    A, slice_ptr, col, val, _ = got
    nr, nc = A.shape
    return SlicedEll(_tensor(slice_ptr), _tensor(col), _tensor(val), nr, nc,
                     int(A.nnz), pick_tpr(slice_ptr, nr))


def sliced_diag_arrays(slice_ptr: np.ndarray, col: np.ndarray,
                       real: np.ndarray, ncols: int):
    """The SlicedDiag index arrays of a SlicedEll layout (host numpy).

    ``slice_ptr``/``col`` as SlicedEll stores them; ``real (E,)`` marks the
    entries that hold a nonzero (the rest is padding).  Every (slice, slot)
    is 32 consecutive entries, so the offsets ``col - row`` of a slot are
    one row of the (E/32, 32) view.  Its base is the middle of the real
    offsets' range; a padding lane takes the column ``row + base``, moved
    into [0, ncols).  A slot fits when every lane's delta is in [-128, 127]
    (the real offsets span at most 255 and the padding reaches a column in
    range); a slice with a slot that does not fit is wide.  Returns ``(base
    (E/32,) int32, delta (E,) int8, wide_ptr (n_slices,) int64, wide_col
    (E_wide,) int32)``."""
    slice_ptr = np.asarray(slice_ptr, np.int64)
    col = np.asarray(col)
    widths = np.diff(slice_ptr) // SLICE
    slots = int(slice_ptr[-1]) // SLICE
    slot_slice = np.repeat(np.arange(widths.size, dtype=np.int64), widths)
    rows = slot_slice[:, None] * SLICE + np.arange(SLICE)       # (slots, 32)
    off = col.reshape(slots, SLICE).astype(np.int64) - rows
    real = np.asarray(real, bool).reshape(slots, SLICE)
    big = np.iinfo(np.int64).max    # every slot of a slice has a real lane
    lo = np.where(real, off, big).min(axis=1)
    hi = np.where(real, off, -big).max(axis=1)
    base = lo + (hi - lo + 1) // 2
    pad = np.clip(rows + base[:, None], 0, max(ncols - 1, 0)) - rows
    d = np.where(real, off, pad) - base[:, None]
    fits = ((d >= -128) & (d <= 127)).all(axis=1)
    wide = np.bincount(slot_slice[~fits], minlength=widths.size) > 0
    wide_slot = wide[slot_slice]
    base = np.where(wide_slot, 0, base).astype(np.int32)
    delta = np.where(wide_slot[:, None], 0, d).astype(np.int8).reshape(-1)
    wide_ptr = np.full(widths.size, -1, np.int64)
    wide_entries = widths[wide] * SLICE
    wide_ptr[wide] = np.cumsum(wide_entries) - wide_entries
    wide_col = col[np.repeat(wide_slot, SLICE)].astype(np.int32)
    return base, delta, wide_ptr, wide_col


def sliced_bytes(slice_ptr: np.ndarray, itemsize: int) -> int:
    """Bytes one SlicedEll apply streams besides x and y: a column and a
    value per stored entry and the slice offsets."""
    return int(slice_ptr[-1]) * (4 + itemsize) + 8 * int(np.size(slice_ptr))


def sliced_diag_bytes(slice_ptr: np.ndarray, wide_ptr: np.ndarray,
                      itemsize: int) -> int:
    """Bytes one SlicedDiag apply streams besides x and y: a value per
    stored entry; a delta per entry and a base per slot of the delta
    slices; a column per entry of the wide slices; both offset tables."""
    widths = np.diff(np.asarray(slice_ptr)) // SLICE
    wide = np.asarray(wide_ptr) >= 0
    entries = int(slice_ptr[-1])
    e_wide = int(widths[wide].sum()) * SLICE
    e_narrow = entries - e_wide
    return (entries * itemsize + e_narrow + 4 * (e_narrow // SLICE)
            + 4 * e_wide + 8 * (int(np.size(slice_ptr)) + int(np.size(wide_ptr))))


def smaller_sliced_diag(slice_ptr: np.ndarray, col: np.ndarray,
                        real: np.ndarray, ncols: int, itemsize: int):
    """The byte half of :func:`sliced_rule`: the
    SlicedDiag index arrays of a SlicedEll layout (see
    :func:`sliced_diag_arrays`) where one apply then streams fewer bytes
    than through SlicedEll (:func:`sliced_diag_bytes` against
    :func:`sliced_bytes`; x and y are the same for both), else None."""
    runs = sliced_diag_arrays(slice_ptr, col, real, ncols)
    if (sliced_diag_bytes(slice_ptr, runs[2], itemsize)
            < sliced_bytes(slice_ptr, itemsize)):
        return runs
    return None


def widest_slice(slice_ptr: np.ndarray) -> int:
    """The widest slice of a sliced layout, in slots."""
    return int((np.diff(np.asarray(slice_ptr)) // SLICE).max(initial=0))


def sliced_rule(slice_ptr: np.ndarray, col: np.ndarray, real: np.ndarray,
                shape, itemsize: int, min_groups: int = 0):
    """The layout rule of the planner, of CG's operator and of the halo
    path's level interiors: SlicedDiag where the operator has at least
    ``min_groups`` row groups of 128 and one apply then streams fewer bytes
    (:func:`smaller_sliced_diag`), else SlicedEll.  Returns ``("sdiag",
    runs, widest slice)`` or ``("sliced", None, threads per row)``."""
    nrows, ncols = shape
    if -(-nrows // 128) >= min_groups:
        runs = smaller_sliced_diag(slice_ptr, col, real, ncols, itemsize)
        if runs is not None:
            return "sdiag", runs, widest_slice(slice_ptr)
    return "sliced", None, pick_tpr(slice_ptr, nrows)


def _sliced_diag(slice_ptr, runs, val, nrows, ncols, nnz) -> SlicedDiag:
    return SlicedDiag(_tensor(slice_ptr), *map(_tensor, runs[:2]), _tensor(val),
                      *map(_tensor, runs[2:]), nrows, ncols, nnz,
                      widest_slice(slice_ptr))


def sliced_diag_from_scipy(A, dtype=torch.float32) -> SlicedDiag:
    """Convert any scipy sparse matrix to SlicedDiag (host tensors);
    duplicates are summed."""
    A, slice_ptr, col, val, real = _sliced_entries(A, dtype)
    runs = sliced_diag_arrays(slice_ptr, col, real, A.shape[1])
    return _sliced_diag(slice_ptr, runs, val, *A.shape, int(A.nnz))


def sliced_layout_from_scipy(A, dtype=torch.float32, min_groups: int = 0):
    """Any scipy sparse matrix as SlicedDiag or SlicedEll by
    :func:`sliced_rule` (SlicedDiag where it has at least ``min_groups``
    row groups and streams fewer bytes per apply)."""
    A, slice_ptr, col, val, real = _sliced_entries(A, dtype)
    nr, nc = A.shape
    tag, runs, extra = sliced_rule(slice_ptr, col, real, A.shape,
                                   val.dtype.itemsize, min_groups)
    if tag == "sliced":
        return SlicedEll(_tensor(slice_ptr), _tensor(col), _tensor(val), nr, nc,
                         int(A.nnz), extra)
    return _sliced_diag(slice_ptr, runs, val, nr, nc, int(A.nnz))


def _check_cols(A, x):
    if x.shape[0] != A.ncols:
        raise ValueError(f"x has {x.shape[0]} rows, operator has {A.ncols} columns")


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for x of shape (N,) or (N, d), dispatched on the layout.
    A callable operator (the halo solver's row-partitioned operators,
    ``parallel/halo.py``) is applied as ``A(x)``."""
    if callable(A):
        return A(x)
    _check_cols(A, x)
    if isinstance(A, SlicedEll):
        return _sliced.sliced_spmv(A.slice_ptr, A.col, A.val, x, A.nrows, A.tpr)
    if isinstance(A, SlicedDiag):
        return _sdiag.sliced_diag_spmv(*_diag_layout_args(A), x, A.nrows)
    if isinstance(A, ShuffleEll):
        return _shuffle_kernel(A.q, A.r, A.v, x, A.nrows)
    if isinstance(A, DiagEll):
        return _diag_kernel(A.start, A.r, A.v, x, A.tg, A.nrows)
    return ell_spmv(A, x)


# The operations of the multigrid cycle around an SpMV.  SlicedEll and
# SlicedDiag compute each in one launch, the SpMV kernel with an epilogue
# (ops/epilogue.py; SlicedDiag has no add, which only transfers need); the
# halo path's PartitionedOp in its two launches, the masked interior and
# halo_spmv with the same epilogue (parallel/halo.py); every other operator
# (another callable, the JAX package's layouts, EllMatrix, a SlicedDiag's
# add) takes the plain composition over spmv.  The choice is by type: a
# kernel that fails raises.  ``row_mask`` (the halo path's interior
# launch) leaves the raw sum on the rows whose bit is set.


def _diag_layout_args(A):
    return A.slice_ptr, A.base, A.delta, A.val, A.wide_ptr, A.wide_col


def _partitioned(A) -> bool:
    from .parallel.halo import PartitionedOp   # imports this module

    return isinstance(A, PartitionedOp)


def spmv_residual(A, x: torch.Tensor, b: torch.Tensor, row_mask=None) -> torch.Tensor:
    """``b - A @ x``."""
    if isinstance(A, SlicedEll):
        _check_cols(A, x)
        return _sliced.sliced_spmv_residual(A.slice_ptr, A.col, A.val, x, b,
                                            A.nrows, A.tpr, row_mask)
    if isinstance(A, SlicedDiag):
        _check_cols(A, x)
        return _sdiag.sliced_diag_spmv_residual(*_diag_layout_args(A), x, b, A.nrows,
                                                row_mask)
    if row_mask is None and _partitioned(A):
        return A.residual(x, b)
    return epilogue_plain("residual", spmv(A, x), b=b, row_mask=row_mask)


def spmv_add(A, x: torch.Tensor, z: torch.Tensor, row_mask=None) -> torch.Tensor:
    """``z + A @ x``."""
    if isinstance(A, SlicedEll):
        _check_cols(A, x)
        return _sliced.sliced_spmv_add(A.slice_ptr, A.col, A.val, x, z, A.nrows,
                                       A.tpr, row_mask)
    if row_mask is None and _partitioned(A):
        return A.add(x, z)
    return epilogue_plain("add", spmv(A, x), z=z, row_mask=row_mask)


def cheb_step(A, dinv: torch.Tensor, b: torch.Tensor, x: torch.Tensor, d, c1,
              c2: float, keep_d: bool = True, row_mask=None):
    """One Chebyshev (or Jacobi) smoother step: ``r = b - A x``, ``d = c1 d
    + (c2 dinv) r`` (``(c2 dinv) r`` where ``c1`` is None: a first step,
    which takes no d), ``x + d``.  ``dinv`` is (n,), broadcast over the
    columns.  Returns ``(x + d, d)``, d None where ``keep_d`` is false;
    the kernels write a given d in place."""
    if isinstance(A, SlicedEll):
        _check_cols(A, x)
        return _sliced.sliced_spmv_cheb(A.slice_ptr, A.col, A.val, x, b, dinv, d,
                                        c1, c2, A.nrows, A.tpr, keep_d, row_mask)
    if isinstance(A, SlicedDiag):
        _check_cols(A, x)
        return _sdiag.sliced_diag_spmv_cheb(*_diag_layout_args(A), x, b, dinv, d,
                                            c1, c2, A.nrows, keep_d, row_mask)
    if row_mask is None and _partitioned(A):
        return A.cheb(dinv, b, x, d, c1, c2, keep_d)
    return epilogue_plain("cheb", spmv(A, x), b=b, dinv=dinv, x=x, d=d, c1=c1,
                          c2=c2, keep_d=keep_d, row_mask=row_mask)


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


@dataclasses.dataclass
class ShuffleTransfer:
    """Grid-transfer pair: U (prolong) and U^T (restrict), both
    gather-formulated SpMVs applied through :func:`spmv`, so any layout
    works (SlicedEll on a single device, a row-partitioned callable on the
    halo path)."""

    U: object   # SlicedEll | ShuffleEll | callable
    UT: object

    @property
    def ncoarse(self):
        return self.U.ncols

    def prolong(self, e):
        return spmv(self.U, e)

    def prolong_add(self, e, x):
        """``x + U e``: the coarse correction, in one launch on a sliced U
        (two on the halo path's partitioned U)."""
        return spmv_add(self.U, e, x)

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

    def prolong_add(self, e: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``x + U e`` (plain: this transfer runs no kernel)."""
        return epilogue_plain("add", self.prolong(e), z=x)

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
