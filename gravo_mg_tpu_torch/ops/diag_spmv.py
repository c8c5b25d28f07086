"""DiagEll SpMV: the CUDA kernel ``csrc/diag_spmv.cu`` and its plain
PyTorch version.

    blk[k, g] = start[g // tg, k] - tg + g % tg
    y[g*128 + l] = sum_k v[k, g, l] * x[blk[k, g]*128 + r[k, g, l]]

Counterpart of ``gravo_mg_tpu/ops/diag_spmv.py`` (``_diag_spmv_pallas``).
The start table keeps the reference's padded offset (g0 + d + tg); the
kernel undoes the pad instead of building the zero-padded ``xb_pad``, and
bounds-checks the column instead.  Any tile size works: the TPU-only
``tg == 512`` gate is gone.

:func:`diag_spmv` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches.
"""

from __future__ import annotations

import torch

from .build import check, load_library
from .shuffle_spmv import check_operands, gather_fma

launches = 0


def diag_spmv_plain(start: torch.Tensor, r: torch.Tensor, v: torch.Tensor,
                    x: torch.Tensor, tg: int, nrows: int) -> torch.Tensor:
    """Plain PyTorch DiagEll SpMV (index gather and a sum over k)."""
    s_pad = r.shape[1]
    g = torch.arange(s_pad, device=r.device)
    tile = g // tg
    blk = start.long()[tile].T - tg + (g - tile * tg)[None, :]   # (KP, S)
    cols = blk[:, :, None] * 128 + r.long()
    return gather_fma(cols, v, x, nrows)


def diag_spmv(start: torch.Tensor, r: torch.Tensor, v: torch.Tensor,
              x: torch.Tensor, tg: int, nrows: int) -> torch.Tensor:
    """y = A @ x for a DiagEll layout; x is (ncols,) or (ncols, d).

    start: (n_tiles, KP) int32 padded start block per (tile, slot); r:
    (KP, S_pad, 128) int8 lane; v: (KP, S_pad, 128) values, same dtype as
    x; tg: row groups per tile.  Returns (nrows,) or (nrows, d).
    """
    if x.device.type == "cpu":
        return diag_spmv_plain(start, r, v, x, tg, nrows)
    if x.device.type != "cuda":
        raise ValueError(f"diag_spmv: unsupported device {x.device}")
    d = check_operands("diag_spmv", start, r, v, x)
    kp, s_pad = r.shape[:2]
    if (start.shape != (s_pad // tg, kp) or s_pad % tg
            or nrows > s_pad * 128):
        raise ValueError("diag_spmv: start/r shapes, tg or nrows disagree")
    y = torch.empty((nrows,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    lib = load_library()
    fn = (lib.gravomg_diag_spmv_f32 if x.dtype == torch.float32
          else lib.gravomg_diag_spmv_f64)
    with torch.cuda.device(x.device):
        err = fn(start.data_ptr(), r.data_ptr(), v.data_ptr(), x.data_ptr(),
                 y.data_ptr(), kp, s_pad, tg, nrows, x.shape[0], d,
                 torch.cuda.current_stream(x.device).cuda_stream)
    check(lib, err, "diag_spmv launch")
    global launches
    launches += 1
    return y
