"""SlicedEll SpMV: the CUDA kernel ``csrc/sliced_spmv.cu`` and its plain
PyTorch version.

    y[32 s + lane] = sum_k val[e] * x[col[e]],   e = slice_ptr[s] + 32 k + lane

for the slots k < w_s = (slice_ptr[s + 1] - slice_ptr[s]) / 32 of slice s.
It computes the function of the JAX package's ShuffleEll SpMV
(``gravo_mg_tpu/ops/shuffle_spmv.py::lane_shuffle_fma`` with the row gather
of ``gravo_mg_tpu/sparse.py``) on a layout built for a GPU instead of the
TPU's per-row-group source blocks (see ``sparse.SlicedEll``).

:func:`sliced_spmv_residual`, :func:`sliced_spmv_add` and
:func:`sliced_spmv_cheb` launch the same kernel with an epilogue
(``ops/epilogue.py``): ``b - A x``, ``z + A x`` and a whole Chebyshev or
Jacobi step, each in one pass and bitwise equal to the plain-mode kernel
followed by the torch ops of :func:`epilogue.epilogue_plain`.  Given a
``row_mask`` (the halo path's interior launch) they apply the epilogue
only on the rows whose bit is clear and store the raw sum on the others,
as ``epilogue_plain(..., row_mask=)`` does.

Every wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches, whatever the epilogue, and ``launches_by_mode`` counts them per
epilogue, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from .build import check, load_library
from .epilogue import MODES, check_epilogue, epilogue_plain

SLICE = 32          # rows per slice: one warp
TPRS = (1, 2, 4, 8, 16, 32)

launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)

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


def _launch(mode: str, tensors, nrows: int, d: int, tpr: int, tail=()) -> None:
    """Launch the kernel with epilogue ``mode`` on the current stream:
    ``tensors`` are the C entry's pointer operands (None for null)."""
    x = tensors[3]
    lib = load_library()
    dt = "f32" if x.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"gravomg_sliced_spmv_{dt}" if mode == "plain"
                 else f"gravomg_sliced_spmv_{mode}_{dt}")
    with torch.cuda.device(x.device):
        err = fn(*(None if t is None else t.data_ptr() for t in tensors),
                 nrows, d, tpr, *tail, torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, f"sliced_spmv ({mode}) launch")
    global launches
    launches += 1
    launches_by_mode[mode] += 1


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"sliced_spmv: unsupported device {x.device}")
    return True


def sliced_spmv(slice_ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                x: torch.Tensor, nrows: int, tpr: int = 1) -> torch.Tensor:
    """y = A @ x for a SlicedEll layout; x is (ncols,) or (ncols, d).

    slice_ptr: (ceil(nrows / 32) + 1,) int64 entry offsets; col: (E,)
    int32; val: (E,) values, same dtype as x; tpr: threads per row on the
    card (1, 2, 4, ..., 32).  Returns (nrows,) or (nrows, d).
    """
    if not _on_card(x):
        return sliced_spmv_plain(slice_ptr, col, val, x, nrows)
    d = check_operands(slice_ptr, col, val, x, nrows, tpr)
    y = torch.empty((nrows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    _launch("plain", (slice_ptr, col, val, x, y), nrows, d, tpr)
    return y


def sliced_spmv_residual(slice_ptr: torch.Tensor, col: torch.Tensor,
                         val: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                         nrows: int, tpr: int = 1, row_mask=None) -> torch.Tensor:
    """``b - A @ x`` in one launch; b has the shape of A @ x.  ``row_mask``
    (int32, one word per slice): the raw sum on the rows whose bit is set."""
    if not _on_card(x):
        return epilogue_plain("residual", sliced_spmv_plain(slice_ptr, col, val, x,
                                                            nrows), b=b,
                              row_mask=row_mask)
    d = check_operands(slice_ptr, col, val, x, nrows, tpr)
    check_epilogue("sliced_spmv_residual", "residual", x, nrows, b=b,
                   row_mask=row_mask)
    y = torch.empty_like(b)
    _launch("residual", (slice_ptr, col, val, x, y, b, row_mask), nrows, d, tpr)
    return y


def sliced_spmv_add(slice_ptr: torch.Tensor, col: torch.Tensor,
                    val: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                    nrows: int, tpr: int = 1, row_mask=None) -> torch.Tensor:
    """``z + A @ x`` in one launch (the prolongation's ``x + U e``, with
    ``e`` as x here); z has the shape of A @ x.  ``row_mask`` as in
    :func:`sliced_spmv_residual`."""
    if not _on_card(x):
        return epilogue_plain("add", sliced_spmv_plain(slice_ptr, col, val, x, nrows),
                              z=z, row_mask=row_mask)
    d = check_operands(slice_ptr, col, val, x, nrows, tpr)
    check_epilogue("sliced_spmv_add", "add", x, nrows, z=z, row_mask=row_mask)
    y = torch.empty_like(z)
    _launch("add", (slice_ptr, col, val, x, y, z, row_mask), nrows, d, tpr)
    return y


def sliced_spmv_cheb(slice_ptr: torch.Tensor, col: torch.Tensor,
                     val: torch.Tensor, x: torch.Tensor, b: torch.Tensor,
                     dinv: torch.Tensor, d, c1, c2: float, nrows: int,
                     tpr: int = 1, keep_d: bool = True, row_mask=None):
    """One smoother step in one launch: ``r = b - A x``, ``d = c1 d +
    (c2 dinv) r`` (``d = (c2 dinv) r`` where ``c1`` is None, a first
    step, which takes no d), ``x_out = x + d``.  A is square; dinv is
    (nrows,).  Returns ``(x_out, d)``: x_out a new tensor; d written in
    place where given, a new tensor on a first step, None where
    ``keep_d`` is false (a Jacobi step).  ``row_mask`` as in
    :func:`sliced_spmv_residual`; d is neither read nor written on the
    rows whose bit is set."""
    if not _on_card(x):
        return epilogue_plain(
            "cheb", sliced_spmv_plain(slice_ptr, col, val, x, nrows), b=b,
            dinv=dinv, x=x, d=d, c1=c1, c2=c2, keep_d=keep_d, row_mask=row_mask)
    nd = check_operands(slice_ptr, col, val, x, nrows, tpr)
    check_epilogue("sliced_spmv_cheb", "cheb", x, nrows, b=b, dinv=dinv, d=d, c1=c1,
                   row_mask=row_mask)
    if d is None and keep_d:
        d = torch.empty_like(b)
    x_out = torch.empty_like(x)
    _launch("cheb", (slice_ptr, col, val, x, x_out, b, dinv, d, row_mask), nrows, nd,
            tpr, (int(c1 is None), 0.0 if c1 is None else float(c1), float(c2)))
    return x_out, (d if keep_d else None)
