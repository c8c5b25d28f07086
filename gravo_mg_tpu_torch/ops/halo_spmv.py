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

:func:`halo_spmv_residual`, :func:`halo_spmv_add` and
:func:`halo_spmv_cheb` launch the same kernel with an epilogue
(``ops/epilogue.py``) applied to ``y[out_row] + halo sum``, indexed by
the output row: after a masked interior launch, which applied the
epilogue on every other row and left the raw sum on these, the two
launches compute ``b - A x``, ``z + A x`` or a whole Chebyshev or Jacobi
step of the partitioned operator, bitwise equal to its plain SpMV
followed by the torch ops.

Every wrapper takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  A part with no rows launches
nothing.  ``launches`` counts kernel launches, whatever the epilogue, and
``launches_by_mode`` counts them per epilogue, so a run can show that it
went through the kernel.
"""

from __future__ import annotations

import torch

from .build import check, load_library
from .epilogue import MODES, check_epilogue, epilogue_plain
from .sliced_spmv import check_operands, sliced_spmv_plain

launches = 0
launches_by_mode = dict.fromkeys(MODES, 0)


def halo_spmv_plain(slice_ptr: torch.Tensor, col: torch.Tensor,
                    val: torch.Tensor, out_row: torch.Tensor,
                    halo: torch.Tensor, y: torch.Tensor, mode: str = "plain",
                    **epilogue):
    """Plain PyTorch halo SpMV: the SlicedEll product over the halo
    buffer, added into ``y`` at ``out_row`` (in place), then ``mode``'s
    epilogue on those rows only (``epilogue_plain`` on the rows gathered
    at ``out_row``, written back there).  Returns ``y``, and for
    ``"cheb"`` ``(y, d)`` with d written at ``out_row`` where given."""
    part = sliced_spmv_plain(slice_ptr, col, val, halo, out_row.numel())
    rows = out_row.long()
    y = y.index_add_(0, rows, part)
    if mode == "plain":
        return y
    at = {k: (v.index_select(0, rows) if isinstance(v, torch.Tensor) else v)
          for k, v in epilogue.items()}
    d = epilogue.get("d")
    if mode == "cheb":
        if at["c1"] is None:
            at["d"] = None
        out, step = epilogue_plain("cheb", y.index_select(0, rows), **at,
                                   keep_d=d is not None)
        if d is not None:
            d.index_copy_(0, rows, step)
        return y.index_copy_(0, rows, out), d
    return y.index_copy_(0, rows, epilogue_plain(mode, y.index_select(0, rows), **at))


def _check(name, slice_ptr, col, val, out_row, halo, y, tpr) -> int:
    """Validate the operands; returns the right-hand-side count d."""
    d = check_operands(slice_ptr, col, val, halo, out_row.numel(), tpr, name)
    if out_row.dtype != torch.int32 or out_row.ndim != 1:
        raise TypeError(f"{name}: out_row must be 1-d int32, got "
                        f"{out_row.dtype} {tuple(out_row.shape)}")
    if y.dtype != halo.dtype:
        raise TypeError(f"{name}: y/halo dtypes {y.dtype}/{halo.dtype}")
    if y.ndim != halo.ndim or y.shape[1:] != halo.shape[1:]:
        raise ValueError(f"{name}: y {tuple(y.shape)} and halo {tuple(halo.shape)} "
                         "differ in their trailing shape")
    for t in (out_row, y):
        if t.device != halo.device or not t.is_contiguous():
            raise ValueError(f"{name}: out_row and y must be contiguous on "
                             f"{halo.device}")
    return d


def _on_card(halo: torch.Tensor) -> bool:
    if halo.device.type == "cpu":
        return False
    if halo.device.type != "cuda":
        raise ValueError(f"halo_spmv: unsupported device {halo.device}")
    return True


def _launch(mode: str, tensors, nrows: int, d: int, tpr: int, tail=()) -> None:
    """Launch the kernel with epilogue ``mode`` on the current stream:
    ``tensors`` are the C entry's pointer operands (None for null)."""
    halo = tensors[4]
    lib = load_library()
    dt = "f32" if halo.dtype == torch.float32 else "f64"
    fn = getattr(lib, f"gravomg_halo_spmv_{dt}" if mode == "plain"
                 else f"gravomg_halo_spmv_{mode}_{dt}")
    with torch.cuda.device(halo.device):
        err = fn(*(None if t is None else t.data_ptr() for t in tensors), nrows, d,
                 tpr, *tail, torch.cuda.current_stream(halo.device).cuda_stream)
    check(lib, err, f"halo_spmv ({mode}) launch")
    global launches
    launches += 1
    launches_by_mode[mode] += 1


def _unshared(name: str, y: torch.Tensor, *vectors) -> None:
    """y is read and written at out_row: it must not share memory with the
    epilogue's vectors."""
    shared = y.untyped_storage().data_ptr()
    if any(t is not None and t.untyped_storage().data_ptr() == shared
           for t in vectors):
        raise ValueError(f"{name}: y is written in place and must not share memory "
                         "with the epilogue's vectors")


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
    if not _on_card(halo):
        return halo_spmv_plain(slice_ptr, col, val, out_row, halo, y)
    nrows = out_row.numel()
    d = _check("halo_spmv", slice_ptr, col, val, out_row, halo, y, tpr)
    if nrows:
        _launch("plain", (slice_ptr, col, val, out_row, halo, y), nrows, d, tpr)
    return y


def halo_spmv_residual(slice_ptr: torch.Tensor, col: torch.Tensor,
                       val: torch.Tensor, out_row: torch.Tensor,
                       halo: torch.Tensor, y: torch.Tensor, b: torch.Tensor,
                       tpr: int = 1) -> torch.Tensor:
    """``y[out_row] = b[out_row] - (y[out_row] + A @ halo)`` in place
    (the boundary rows of ``b - A x``, y holding the interior's raw sums
    there); b has y's shape.  Returns ``y``."""
    if not _on_card(halo):
        return halo_spmv_plain(slice_ptr, col, val, out_row, halo, y, "residual", b=b)
    name = "halo_spmv_residual"
    d = _check(name, slice_ptr, col, val, out_row, halo, y, tpr)
    check_epilogue(name, "residual", y, y.shape[0], b=b)
    _unshared(name, y, b)
    if out_row.numel():
        _launch("residual", (slice_ptr, col, val, out_row, halo, y, b),
                out_row.numel(), d, tpr)
    return y


def halo_spmv_add(slice_ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                  out_row: torch.Tensor, halo: torch.Tensor, y: torch.Tensor,
                  z: torch.Tensor, tpr: int = 1) -> torch.Tensor:
    """``y[out_row] = z[out_row] + (y[out_row] + A @ halo)`` in place (the
    boundary rows of the prolongation's ``x + U e``); z has y's shape.
    Returns ``y``."""
    if not _on_card(halo):
        return halo_spmv_plain(slice_ptr, col, val, out_row, halo, y, "add", z=z)
    name = "halo_spmv_add"
    d = _check(name, slice_ptr, col, val, out_row, halo, y, tpr)
    check_epilogue(name, "add", y, y.shape[0], z=z)
    _unshared(name, y, z)
    if out_row.numel():
        _launch("add", (slice_ptr, col, val, out_row, halo, y, z), out_row.numel(),
                d, tpr)
    return y


def halo_spmv_cheb(slice_ptr: torch.Tensor, col: torch.Tensor, val: torch.Tensor,
                   out_row: torch.Tensor, halo: torch.Tensor, y: torch.Tensor,
                   x: torch.Tensor, b: torch.Tensor, dinv: torch.Tensor, d, c1,
                   c2: float, tpr: int = 1):
    """The boundary rows of one smoother step, in place: at each ``o`` in
    ``out_row``, ``r = b - (y + A @ halo)``, ``d = c1 d + (c2 dinv) r``
    (``(c2 dinv) r`` where ``c1`` is None), ``y = x + d``; y holds the
    interior's raw sums there and becomes the new iterate.  ``d`` is the
    interior launch's step buffer, read at out_row unless c1 is None and
    written there; None keeps no step (a Jacobi step).  Returns ``(y,
    d)``."""
    if not _on_card(halo):
        return halo_spmv_plain(slice_ptr, col, val, out_row, halo, y, "cheb", x=x,
                               b=b, dinv=dinv, d=d, c1=c1, c2=c2)
    name = "halo_spmv_cheb"
    nd = _check(name, slice_ptr, col, val, out_row, halo, y, tpr)
    check_epilogue(name, "cheb", x, y.shape[0], b=b, dinv=dinv, d=d, c1=c1,
                   d_out=True)
    if x.shape != y.shape:
        raise ValueError(f"{name}: x {tuple(x.shape)} and y {tuple(y.shape)} differ")
    _unshared(name, y, x, b, dinv, d)
    if out_row.numel():
        _launch("cheb", (slice_ptr, col, val, out_row, halo, y, x, b, dinv, d),
                out_row.numel(), nd, tpr,
                (int(c1 is None), 0.0 if c1 is None else float(c1), float(c2)))
    return y, d
