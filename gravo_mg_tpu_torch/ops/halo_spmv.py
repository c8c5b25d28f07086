"""Halo SpMV: the boundary-row part of a row-partitioned operator
(``parallel/halo.py``), added into the interior part's output.

    y[out_row[i]] += sum_k val[e] * halo[col[e]],   e = slice_ptr[i // 32] + 32 k + i % 32

over the rows i of a SlicedEll that holds only the rows with an entry
outside their partition, its columns into the halo buffer.  The CUDA
kernel is ``halo_spmv_kernel`` in ``csrc/sliced_spmv.cu``: the loop of
``sliced_spmv_kernel``, with each row's sum added to ``y[out_row[i]]``.
After the interior part's ``sliced_spmv``/``sliced_diag_spmv`` launch on
the same stream it completes the function of the JAX package's
``_dist_spmv`` (``gravo_mg_tpu/parallel/halo.py``: the TPU kernel
``gravo_mg_tpu/ops/shuffle_spmv.py::lane_shuffle_fma`` over an interior
and a halo part, then their sum), in its order: the interior sum first,
the halo sum added to it.  ``out_row`` is unique, so the kernel needs no
atomics.

:func:`halo_spmv` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  A part with no rows launches
nothing.  ``launches`` counts kernel launches, so a run can show that it
went through the kernel.
"""

from __future__ import annotations

import torch

from .build import check, load_library
from .sliced_spmv import check_operands, sliced_spmv_plain

launches = 0


def halo_spmv_plain(slice_ptr: torch.Tensor, col: torch.Tensor,
                    val: torch.Tensor, out_row: torch.Tensor,
                    halo: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch halo SpMV: the SlicedEll product over the halo
    buffer, added into ``y`` at ``out_row`` (in place; returns ``y``)."""
    part = sliced_spmv_plain(slice_ptr, col, val, halo, out_row.numel())
    return y.index_add_(0, out_row.long(), part)


def halo_spmv(slice_ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
              out_row: torch.Tensor, halo: torch.Tensor, y: torch.Tensor,
              tpr: int = 1) -> torch.Tensor:
    """``y[out_row] += A @ halo`` in place for a SlicedEll ``A`` of
    ``out_row.numel()`` rows; returns ``y``.

    slice_ptr: (ceil(rows / 32) + 1,) int64 entry offsets; col: (E,) int32
    halo-buffer positions; val: (E,) values; out_row: (rows,) int32, unique
    rows of y; halo: (H,) or (H, d), same dtype as val; y: (N,) or (N, d)
    with halo's trailing shape; tpr: threads per row on the card.
    """
    if halo.device.type == "cpu":
        return halo_spmv_plain(slice_ptr, col, val, out_row, halo, y)
    if halo.device.type != "cuda":
        raise ValueError(f"halo_spmv: unsupported device {halo.device}")
    nrows = out_row.numel()
    d = check_operands(slice_ptr, col, val, halo, nrows, tpr, "halo_spmv")
    if out_row.dtype != torch.int32 or out_row.ndim != 1:
        raise TypeError(f"halo_spmv: out_row must be 1-d int32, got "
                        f"{out_row.dtype} {tuple(out_row.shape)}")
    if y.dtype != halo.dtype:
        raise TypeError(f"halo_spmv: y/halo dtypes {y.dtype}/{halo.dtype}")
    if y.ndim != halo.ndim or y.shape[1:] != halo.shape[1:]:
        raise ValueError(f"halo_spmv: y {tuple(y.shape)} and halo {tuple(halo.shape)} "
                         "differ in their trailing shape")
    for t in (out_row, y):
        if t.device != halo.device or not t.is_contiguous():
            raise ValueError("halo_spmv: out_row and y must be contiguous on "
                             f"{halo.device}")
    if nrows == 0:
        return y
    lib = load_library()
    fn = (lib.gravomg_halo_spmv_f32 if halo.dtype == torch.float32
          else lib.gravomg_halo_spmv_f64)
    with torch.cuda.device(halo.device):
        err = fn(slice_ptr.data_ptr(), col.data_ptr(), val.data_ptr(),
                 out_row.data_ptr(), halo.data_ptr(), y.data_ptr(), nrows, d, tpr,
                 torch.cuda.current_stream(halo.device).cuda_stream)
    check(lib, err, "halo_spmv launch")
    global launches
    launches += 1
    return y
