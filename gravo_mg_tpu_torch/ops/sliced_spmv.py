"""SlicedEll SpMV: the CUDA kernel ``csrc/sliced_spmv.cu`` and its plain
PyTorch version.

    y[32 s + lane] = sum_k val[e] * x[col[e]],   e = slice_ptr[s] + 32 k + lane

for the slots k < w_s = (slice_ptr[s + 1] - slice_ptr[s]) / 32 of slice s.
It computes the function of the JAX package's ShuffleEll SpMV
(``gravo_mg_tpu/ops/shuffle_spmv.py::lane_shuffle_fma`` with the row gather
of ``gravo_mg_tpu/sparse.py``) on a layout built for a GPU instead of the
TPU's per-row-group source blocks (see ``sparse.SlicedEll``).

:func:`sliced_spmv` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from .build import check, load_library

SLICE = 32          # rows per slice: one warp
TPRS = (1, 2, 4, 8, 16, 32)

launches = 0

_FLOATS = (torch.float32, torch.float64)


def entry_rows(slice_ptr: torch.Tensor) -> torch.Tensor:
    """The output row of every stored entry (int64, on slice_ptr's device)."""
    widths = torch.diff(slice_ptr)
    n_slices = widths.numel()
    dev = slice_ptr.device
    sl = torch.repeat_interleave(torch.arange(n_slices, device=dev), widths)
    lane = (torch.arange(sl.numel(), device=dev) - slice_ptr[sl]) % SLICE
    return sl * SLICE + lane


def sliced_spmv_plain(slice_ptr: torch.Tensor, col: torch.Tensor,
                      val: torch.Tensor, x: torch.Tensor,
                      nrows: int) -> torch.Tensor:
    """Plain PyTorch SlicedEll SpMV: gather x by column and sum the slots
    of each row (padding entries carry weight 0)."""
    rows = entry_rows(slice_ptr)
    x2 = x.reshape(x.shape[0], -1)
    contrib = val[:, None] * x2[col.long()]
    n_pad = (slice_ptr.numel() - 1) * SLICE
    y = torch.zeros((n_pad, x2.shape[1]), dtype=x.dtype, device=x.device)
    y.index_add_(0, rows, contrib)
    y = y[:nrows]
    return y.reshape(nrows) if x.ndim == 1 else y


def check_operands(slice_ptr: torch.Tensor, col: torch.Tensor,
                   val: torch.Tensor, x: torch.Tensor, nrows: int,
                   tpr: int, name: str = "sliced_spmv") -> int:
    """Validate the kernel operands; returns the right-hand-side count d."""
    if x.ndim not in (1, 2):
        raise ValueError(f"{name}: x must be (n,) or (n, d), got {tuple(x.shape)}")
    if val.dtype not in _FLOATS or x.dtype != val.dtype:
        raise TypeError(f"{name}: val/x dtypes {val.dtype}/{x.dtype}; "
                        "need equal f32 or f64")
    if slice_ptr.dtype != torch.int64 or col.dtype != torch.int32:
        raise TypeError(f"{name}: slice_ptr must be int64 and col int32, "
                        f"got {slice_ptr.dtype}/{col.dtype}")
    if col.ndim != 1 or col.shape != val.shape:
        raise ValueError(f"{name}: col/val must be (E,), got "
                         f"{tuple(col.shape)}/{tuple(val.shape)}")
    if slice_ptr.shape != (-(-nrows // SLICE) + 1,):
        raise ValueError(f"{name}: slice_ptr has {slice_ptr.numel()} "
                         f"entries for {nrows} rows")
    if tpr not in TPRS:
        raise ValueError(f"{name}: threads per row {tpr} not in {TPRS}")
    for t in (slice_ptr, col, val, x):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return 1 if x.ndim == 1 else x.shape[1]


def sliced_spmv(slice_ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                x: torch.Tensor, nrows: int, tpr: int = 1) -> torch.Tensor:
    """y = A @ x for a SlicedEll layout; x is (ncols,) or (ncols, d).

    slice_ptr: (ceil(nrows / 32) + 1,) int64 entry offsets; col: (E,)
    int32; val: (E,) values, same dtype as x; tpr: threads per row on the
    card (1, 2, 4, ..., 32).  Returns (nrows,) or (nrows, d).
    """
    if x.device.type == "cpu":
        return sliced_spmv_plain(slice_ptr, col, val, x, nrows)
    if x.device.type != "cuda":
        raise ValueError(f"sliced_spmv: unsupported device {x.device}")
    d = check_operands(slice_ptr, col, val, x, nrows, tpr)
    y = torch.empty((nrows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    lib = load_library()
    fn = (lib.gravomg_sliced_spmv_f32 if x.dtype == torch.float32
          else lib.gravomg_sliced_spmv_f64)
    with torch.cuda.device(x.device):
        err = fn(slice_ptr.data_ptr(), col.data_ptr(), val.data_ptr(),
                 x.data_ptr(), y.data_ptr(), nrows, d, tpr,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "sliced_spmv launch")
    global launches
    launches += 1
    return y
