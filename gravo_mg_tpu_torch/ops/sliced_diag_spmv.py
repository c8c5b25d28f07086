"""SlicedDiag SpMV: the CUDA kernels ``csrc/sliced_diag_spmv.cu`` and their
plain PyTorch version.

    col[e] = 32 s + lane + base[slice_ptr[s] / 32 + k] + delta[e]   (a delta slice)
           = wide_col[wide_ptr[s] + e - slice_ptr[s]]                (a wide slice)
    y[32 s + lane] = sum_k val[e] * x[col[e]],   e = slice_ptr[s] + 32 k + lane

for the slots k < w_s = (slice_ptr[s + 1] - slice_ptr[s]) / 32 of slice s.
It computes the function of the JAX package's DiagEll SpMV
(``gravo_mg_tpu/ops/diag_spmv.py::_diag_spmv_pallas``) on a layout built
for a GPU instead of the TPU's (tile, block diagonal) slots (see
``sparse.SlicedDiag``).  The kernel has two variants, both built:
``"direct"`` (each warp streams its slice's values and deltas from device
memory) and ``"staged"`` (a persistent grid whose blocks copy the next
slices' values and deltas into shared memory with TMA bulk copies while
they sum the current ones).  :data:`PREFERRED`, the wrapper's default and
so the one every solve runs, is the faster of the two in an H100
measurement at the 1M operators' shapes (PERF.md).

:func:`sliced_diag_spmv` takes the plain version for CPU tensors only; for
CUDA tensors it launches the kernel or raises.  ``launches`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from .build import check, load_library
from .sliced_spmv import SLICE, entry_rows, sliced_spmv_plain

VARIANTS = ("direct", "staged")
PREFERRED = "direct"

launches = 0

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
                   x: torch.Tensor, nrows: int, variant: str) -> int:
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
    if variant not in VARIANTS:
        raise ValueError(f"sliced_diag_spmv: variant {variant!r} not in {VARIANTS}")
    for t in (slice_ptr, base, delta, val, wide_ptr, wide_col):
        if t.device != x.device:
            raise ValueError(f"sliced_diag_spmv: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("sliced_diag_spmv: operands must be contiguous")
    if not x.is_contiguous():
        raise ValueError("sliced_diag_spmv: operands must be contiguous")
    if variant == "staged" and (val.data_ptr() % 16 or delta.data_ptr() % 16):
        raise ValueError("sliced_diag_spmv: the staged variant needs val and delta "
                         "16-byte aligned (bulk copies)")
    return 1 if x.ndim == 1 else x.shape[1]


def sliced_diag_spmv(slice_ptr: torch.Tensor, base: torch.Tensor,
                     delta: torch.Tensor, val: torch.Tensor,
                     wide_ptr: torch.Tensor, wide_col: torch.Tensor,
                     x: torch.Tensor, nrows: int, wmax: int,
                     variant: str = PREFERRED) -> torch.Tensor:
    """y = A @ x for a SlicedDiag layout; x is (ncols,) or (ncols, d).

    slice_ptr: (ceil(nrows / 32) + 1,) int64 entry offsets; base: (E/32,)
    int32; delta: (E,) int8; val: (E,) values, same dtype as x; wide_ptr:
    (ceil(nrows / 32),) int64, -1 for a delta slice; wide_col: (E_wide,)
    int32; wmax: the widest slice in slots; variant: "direct" or "staged"
    (which refuses a slice of more than 72 KB of values and deltas).
    Returns (nrows,) or (nrows, d).
    """
    if x.device.type == "cpu":
        return sliced_diag_spmv_plain(slice_ptr, base, delta, val, wide_ptr,
                                      wide_col, x, nrows)
    if x.device.type != "cuda":
        raise ValueError(f"sliced_diag_spmv: unsupported device {x.device}")
    d = check_operands(slice_ptr, base, delta, val, wide_ptr, wide_col, x,
                       nrows, variant)
    y = torch.empty((nrows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    lib = load_library()
    fn = (lib.gravomg_sliced_diag_spmv_f32 if x.dtype == torch.float32
          else lib.gravomg_sliced_diag_spmv_f64)
    with torch.cuda.device(x.device):
        err = fn(slice_ptr.data_ptr(), base.data_ptr(), delta.data_ptr(),
                 val.data_ptr(), wide_ptr.data_ptr(), wide_col.data_ptr(),
                 x.data_ptr(), y.data_ptr(), nrows, d, wmax,
                 VARIANTS.index(variant),
                 torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, f"sliced_diag_spmv ({variant}) launch")
    global launches
    launches += 1
    return y
