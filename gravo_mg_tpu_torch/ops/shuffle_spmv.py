"""ShuffleEll SpMV: the CUDA kernel ``csrc/shuffle_spmv.cu`` and its plain
PyTorch version.

    y[s*128 + l] = sum_k v[k, s, l] * x[q[k, s]*128 + r[k, s, l]]

Counterpart of ``gravo_mg_tpu/ops/shuffle_spmv.py`` (``lane_shuffle_fma``
plus the row gather in ``gravo_mg_tpu/sparse.py``).  The kernel reads x
directly, so the TPU's gathered intermediate ``z`` never exists.

:func:`shuffle_spmv` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from .build import check, load_library

launches = 0

_FLOATS = (torch.float32, torch.float64)


def gather_fma(cols: torch.Tensor, v: torch.Tensor, x: torch.Tensor,
               nrows: int) -> torch.Tensor:
    """Plain ``y = sum_k v[k] * x[cols[k]]`` over (KP, S, 128) slot arrays;
    columns outside [0, len(x)) read zero (they carry v == 0)."""
    ncols = x.shape[0]
    x2 = x.reshape(ncols, -1)
    valid = (cols >= 0) & (cols < ncols)
    g = x2[cols.clamp(0, max(ncols - 1, 0))]            # (KP, S, 128, d)
    g = torch.where(valid[..., None], g, g.new_zeros(()))
    y = (v[..., None] * g).sum(0).reshape(-1, x2.shape[1])[:nrows]
    return y.reshape(nrows) if x.ndim == 1 else y


def shuffle_spmv_plain(q: torch.Tensor, r: torch.Tensor, v: torch.Tensor,
                       x: torch.Tensor, nrows: int) -> torch.Tensor:
    """Plain PyTorch ShuffleEll SpMV (index gather and a sum over k)."""
    cols = q.long()[:, :, None] * 128 + r.long()
    return gather_fma(cols, v, x, nrows)


def check_operands(name: str, table: torch.Tensor, r: torch.Tensor,
                   v: torch.Tensor, x: torch.Tensor) -> int:
    """Validate the kernel operands; returns the right-hand-side count d."""
    if x.ndim not in (1, 2):
        raise ValueError(f"{name}: x must be (n,) or (n, d), got {tuple(x.shape)}")
    if v.dtype not in _FLOATS or x.dtype != v.dtype:
        raise TypeError(f"{name}: v/x dtypes {v.dtype}/{x.dtype}; need equal f32 or f64")
    if table.dtype != torch.int32 or r.dtype != torch.int8:
        raise TypeError(f"{name}: index table must be int32 and r int8, got "
                        f"{table.dtype}/{r.dtype}")
    if r.shape != v.shape or r.ndim != 3 or r.shape[2] != 128:
        raise ValueError(f"{name}: r/v must be (KP, S, 128), got "
                         f"{tuple(r.shape)}/{tuple(v.shape)}")
    for t in (table, r, v, x):
        if t.device != x.device:
            raise ValueError(f"{name}: operands on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return 1 if x.ndim == 1 else x.shape[1]


def shuffle_spmv(q: torch.Tensor, r: torch.Tensor, v: torch.Tensor,
                 x: torch.Tensor, nrows: int) -> torch.Tensor:
    """y = A @ x for a ShuffleEll layout; x is (ncols,) or (ncols, d).

    q: (KP, S) int32 source block per (slot, row group); r: (KP, S, 128)
    int8 lane; v: (KP, S, 128) values, same dtype as x.  Returns (nrows,)
    or (nrows, d).
    """
    if x.device.type == "cpu":
        return shuffle_spmv_plain(q, r, v, x, nrows)
    if x.device.type != "cuda":
        raise ValueError(f"shuffle_spmv: unsupported device {x.device}")
    d = check_operands("shuffle_spmv", q, r, v, x)
    kp, s = q.shape
    if r.shape[:2] != (kp, s) or nrows > s * 128:
        raise ValueError("shuffle_spmv: q/r shapes or nrows disagree")
    y = torch.empty((nrows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    lib = load_library()
    fn = (lib.gravomg_shuffle_spmv_f32 if x.dtype == torch.float32
          else lib.gravomg_shuffle_spmv_f64)
    with torch.cuda.device(x.device):
        err = fn(q.data_ptr(), r.data_ptr(), v.data_ptr(), x.data_ptr(),
                 y.data_ptr(), kp, s, nrows, x.shape[0], d,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "shuffle_spmv launch")
    global launches
    launches += 1
    return y
