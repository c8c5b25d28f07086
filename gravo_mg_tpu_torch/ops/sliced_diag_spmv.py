"""SlicedDiag SpMV: the CUDA kernels ``csrc/sliced_diag_spmv.cu`` and their
plain PyTorch version.

    col[e] = 32 s + lane + base[slice_ptr[s] / 32 + k] + delta[e]   (a delta slice)
           = wide_col[wide_ptr[s] + e - slice_ptr[s]]                (a wide slice)
    y[32 s + lane] = sum_k val[e] * x[col[e]],   e = slice_ptr[s] + 32 k + lane

for the slots k < w_s = (slice_ptr[s + 1] - slice_ptr[s]) / 32 of slice s.
It computes the function of the JAX package's DiagEll SpMV
(``gravo_mg_tpu/ops/diag_spmv.py::_diag_spmv_pallas``) on a layout built
for a GPU instead of the TPU's (tile, block diagonal) slots (see
``sparse.SlicedDiag``): each warp streams its slice's values and deltas
from device memory.

:func:`sliced_diag_spmv_residual` and :func:`sliced_diag_spmv_cheb`
launch the same kernel with an epilogue (``ops/epilogue.py``): ``b - A x``
and a whole Chebyshev or Jacobi step, each in one pass and bitwise equal
to the plain-mode kernel followed by the torch ops of
:func:`epilogue.epilogue_plain` (no operator in this layout is a transfer,
so no caller needs the add).  Given a ``row_mask`` (the halo path's
stacked level-0 interior) they apply the epilogue only on the rows whose
bit is clear and store the raw sum on the others, as
``epilogue_plain(..., row_mask=)`` does.

Every wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches, whatever the epilogue, and ``launches_by_mode`` counts them per
epilogue, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from .build import check, load_library
from .epilogue import MODES, check_epilogue, epilogue_plain
from .sliced_spmv import SLICE, entry_rows, sliced_spmv_plain

launches = 0
launches_by_mode = dict.fromkeys((m for m in MODES if m != "add"), 0)

_FLOATS = (torch.float32, torch.float64)
_INT32_ROWS = 2**31 - SLICE


def sliced_diag_columns(slice_ptr: torch.Tensor, base: torch.Tensor,
                        delta: torch.Tensor, wide_ptr: torch.Tensor,
                        wide_col: torch.Tensor) -> torch.Tensor:
    """The column of every stored entry (int64), rebuilt from the runs of
    the delta slices and the columns of the wide slices."""
    rows = entry_rows(slice_ptr)
    e = torch.arange(delta.numel(), device=delta.device)
    col = rows + base.long()[e // SLICE] + delta.long()
    sl = rows // SLICE
    wp = wide_ptr[sl]
    wide = wp >= 0
    col[wide] = wide_col.long()[(wp + e - slice_ptr[sl])[wide]]
    return col


def sliced_diag_spmv_plain(slice_ptr: torch.Tensor, base: torch.Tensor,
                           delta: torch.Tensor, val: torch.Tensor,
                           wide_ptr: torch.Tensor, wide_col: torch.Tensor,
                           x: torch.Tensor, nrows: int) -> torch.Tensor:
    """Plain PyTorch SlicedDiag SpMV: rebuild the columns, gather x and
    sum the slots of each row (padding entries carry weight 0)."""
    col = sliced_diag_columns(slice_ptr, base, delta, wide_ptr, wide_col)
    return sliced_spmv_plain(slice_ptr, col, val, x, nrows)


def check_operands(slice_ptr: torch.Tensor, base: torch.Tensor,
                   delta: torch.Tensor, val: torch.Tensor,
                   wide_ptr: torch.Tensor, wide_col: torch.Tensor,
                   x: torch.Tensor, nrows: int) -> int:
    """Validate the kernel operands; returns the right-hand-side count d."""
    if x.ndim not in (1, 2):
        raise ValueError(f"sliced_diag_spmv: x must be (n,) or (n, d), got {tuple(x.shape)}")
    if val.dtype not in _FLOATS or x.dtype != val.dtype:
        raise TypeError(f"sliced_diag_spmv: val/x dtypes {val.dtype}/{x.dtype}; "
                        "need equal f32 or f64")
    want = {"slice_ptr": (slice_ptr, torch.int64), "base": (base, torch.int32),
            "delta": (delta, torch.int8), "wide_ptr": (wide_ptr, torch.int64),
            "wide_col": (wide_col, torch.int32)}
    for name, (t, dtype) in want.items():
        if t.dtype != dtype or t.ndim != 1:
            raise TypeError(f"sliced_diag_spmv: {name} must be 1-d {dtype}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    n_slices = -(-nrows // SLICE)
    if (delta.shape != val.shape or val.ndim != 1 or delta.numel() % SLICE
            or base.numel() * SLICE != delta.numel()):
        raise ValueError(f"sliced_diag_spmv: delta/val must be (E,) with E a multiple "
                         f"of {SLICE} and base (E/{SLICE},), got {tuple(delta.shape)}/"
                         f"{tuple(val.shape)}/{tuple(base.shape)}")
    if slice_ptr.numel() != n_slices + 1 or wide_ptr.numel() != n_slices:
        raise ValueError(f"sliced_diag_spmv: slice_ptr/wide_ptr have {slice_ptr.numel()}/"
                         f"{wide_ptr.numel()} entries for {nrows} rows")
    if nrows >= _INT32_ROWS or x.shape[0] >= 2**31:
        raise ValueError("sliced_diag_spmv: rows and columns must fit int32")
    for t in (slice_ptr, base, delta, val, wide_ptr, wide_col):
        if t.device != x.device:
            raise ValueError(f"sliced_diag_spmv: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("sliced_diag_spmv: operands must be contiguous")
    if not x.is_contiguous():
        raise ValueError("sliced_diag_spmv: operands must be contiguous")
    return 1 if x.ndim == 1 else x.shape[1]


def _launch(mode: str, tensors, nrows: int, d: int, tail=()) -> None:
    """Launch the kernel with epilogue ``mode`` on the current stream:
    ``tensors`` are the C entry's pointer operands (None for null)."""
    x = tensors[6]
    lib = load_library()
    dt = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"gravomg_sliced_diag_spmv_{dt}" if mode == "plain"
                 else f"gravomg_sliced_diag_spmv_{mode}_{dt}")
    with torch.cuda.device(x.device):
        err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                 nrows, d, *tail, torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, f"sliced_diag_spmv ({mode}) launch")
    global launches
    launches += 1
    launches_by_mode[mode] += 1


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"sliced_diag_spmv: unsupported device {x.device}")
    return True


def sliced_diag_spmv(slice_ptr: torch.Tensor, base: torch.Tensor,
                     delta: torch.Tensor, val: torch.Tensor,
                     wide_ptr: torch.Tensor, wide_col: torch.Tensor,
                     x: torch.Tensor, nrows: int) -> torch.Tensor:
    """y = A @ x for a SlicedDiag layout; x is (ncols,) or (ncols, d).

    slice_ptr: (ceil(nrows / 32) + 1,) int64 entry offsets; base: (E/32,)
    int32; delta: (E,) int8; val: (E,) values, same dtype as x; wide_ptr:
    (ceil(nrows / 32),) int64, -1 for a delta slice; wide_col: (E_wide,)
    int32.  Returns (nrows,) or (nrows, d).
    """
    layout = (slice_ptr, base, delta, val, wide_ptr, wide_col)
    if not _on_card(x):
        return sliced_diag_spmv_plain(*layout, x, nrows)
    d = check_operands(*layout, x, nrows)
    y = torch.empty((nrows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    _launch("plain", (*layout, x, y), nrows, d)
    return y


def sliced_diag_spmv_residual(slice_ptr: torch.Tensor, base: torch.Tensor,
                              delta: torch.Tensor, val: torch.Tensor,
                              wide_ptr: torch.Tensor, wide_col: torch.Tensor,
                              x: torch.Tensor, b: torch.Tensor,
                              nrows: int, row_mask=None) -> torch.Tensor:
    """``b - A @ x`` in one launch; b has the shape of A @ x.  ``row_mask``
    (int32, one word per slice): the raw sum on the rows whose bit is set."""
    layout = (slice_ptr, base, delta, val, wide_ptr, wide_col)
    if not _on_card(x):
        return epilogue_plain("residual", sliced_diag_spmv_plain(*layout, x, nrows),
                              b=b, row_mask=row_mask)
    d = check_operands(*layout, x, nrows)
    check_epilogue("sliced_diag_spmv_residual", "residual", x, nrows, b=b,
                   row_mask=row_mask)
    y = torch.empty_like(b)
    _launch("residual", (*layout, x, y, b, row_mask), nrows, d)
    return y


def sliced_diag_spmv_cheb(slice_ptr: torch.Tensor, base: torch.Tensor,
                          delta: torch.Tensor, val: torch.Tensor,
                          wide_ptr: torch.Tensor, wide_col: torch.Tensor,
                          x: torch.Tensor, b: torch.Tensor, dinv: torch.Tensor,
                          d, c1, c2: float, nrows: int, keep_d: bool = True,
                          row_mask=None):
    """One smoother step in one launch, as :func:`sliced_spmv.sliced_spmv_cheb`:
    ``r = b - A x``, ``d = c1 d + (c2 dinv) r`` (no ``c1 d`` term and no d
    taken where ``c1`` is None), ``x_out = x + d``.  Returns ``(x_out,
    d)``: d written in place where given, a new tensor on a first step,
    None where ``keep_d`` is false.  ``row_mask`` as in
    :func:`sliced_diag_spmv_residual`; d is neither read nor written on
    the rows whose bit is set."""
    layout = (slice_ptr, base, delta, val, wide_ptr, wide_col)
    if not _on_card(x):
        return epilogue_plain(
            "cheb", sliced_diag_spmv_plain(*layout, x, nrows), b=b, dinv=dinv, x=x,
            d=d, c1=c1, c2=c2, keep_d=keep_d, row_mask=row_mask)
    nd = check_operands(*layout, x, nrows)
    check_epilogue("sliced_diag_spmv_cheb", "cheb", x, nrows, b=b, dinv=dinv, d=d,
                   c1=c1, row_mask=row_mask)
    if d is None and keep_d:
        d = torch.empty_like(b)
    x_out = torch.empty_like(x)
    _launch("cheb", (*layout, x, x_out, b, dinv, d, row_mask), nrows, nd,
            (int(c1 is None), 0.0 if c1 is None else float(c1), float(c2)))
    return x_out, (d if keep_d else None)
