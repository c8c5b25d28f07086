"""The epilogues of the SpMV kernels ``sliced_spmv`` and
``sliced_diag_spmv``: the operation of the multigrid cycle that one launch
computes around its sum ``s = A x``,

    plain      y = s
    residual   y = b - s
    add        y = z + s                       (the prolongation's x + U e)
    cheb       r = b - s;  d = c1 d + (c2 dinv) r;  x_out = x + d
               (the first step of a Chebyshev sweep, and every Jacobi step,
               has no c1 d term: d = (c2 dinv) r)

The JAX package computes each of these as the Pallas SpMV and an XLA
fusion around it (``gravo_mg_tpu/solver/smoothers.py``,
``gravo_mg_tpu/solver/multigrid.py``); the kernels compute them in one
pass (``csrc/spmv_common.cuh``).  :func:`epilogue_plain` is the plain
version: the torch ops the port's cycle ran after the SpMV, in that order,
so ``epilogue_plain(mode, <SpMV>(...), ...)`` is each operation's plain
version, and with the kernel's own plain-mode SpMV the bitwise reference
of its fused launch.

On the halo path (``parallel/halo.py``) an operation is two launches: the
interior part under a **row mask** (:func:`row_mask_from_rows`: one int32
word per 32-row slice, bit ``r`` of word ``s`` set when row ``32 s + r``
has a halo part), which applies the epilogue on the other rows and leaves
the raw sum on those (``epilogue_plain(..., row_mask=)``), then
``halo_spmv`` in the same mode, which adds the halo sum and applies the
epilogue on the boundary rows.
"""

from __future__ import annotations

import numpy as np
import torch

MODES = ("plain", "residual", "add", "cheb")


def row_mask_from_rows(rows: np.ndarray, nrows: int) -> torch.Tensor:
    """The row mask of a masked launch over ``nrows`` rows (host int32,
    ``(ceil(nrows / 32),)``): bit ``r % 32`` of word ``r // 32`` set for
    each row ``r`` in ``rows``."""
    rows = np.asarray(rows, dtype=np.int64)
    words = np.zeros(-(-nrows // 32), np.uint32)
    np.bitwise_or.at(words, rows // 32, np.left_shift(1, rows % 32).astype(np.uint32))
    return torch.from_numpy(words.view(np.int32))


def masked_rows(row_mask: torch.Tensor, nrows: int) -> torch.Tensor:
    """The rows whose bit is set in ``row_mask``, as a bool (nrows,)."""
    r = torch.arange(nrows, device=row_mask.device)
    return ((row_mask.long()[r // 32] >> (r % 32)) & 1).bool()


def epilogue_plain(mode: str, y: torch.Tensor, *, b=None, z=None, dinv=None,
                   x=None, d=None, c1=None, c2=None, keep_d=True, row_mask=None):
    """Apply ``mode``'s torch ops to the SpMV result ``y``.  Returns ``y``,
    ``b - y`` or ``z + y``, and for ``"cheb"`` the pair ``(x + d_new,
    d_new)``, ``d_new`` None where ``keep_d`` is false; ``c1`` is None on
    a first step (``d`` is then not read).

    With ``row_mask`` (a masked launch's plain version) the rows whose bit
    is set keep the raw sum ``y``, and ``d_new`` holds the given ``d``
    there (zero on a first step, where a kernel leaves it unwritten)."""
    if mode == "plain":
        return y
    if row_mask is not None:
        out = epilogue_plain(mode, y, b=b, z=z, dinv=dinv, x=x, d=d, c1=c1, c2=c2,
                             keep_d=keep_d)
        m = masked_rows(row_mask, y.shape[0])
        m = m[:, None] if y.ndim == 2 else m
        if mode != "cheb":
            return torch.where(m, y, out)
        x_out, step = out
        if step is not None:
            step = torch.where(m, torch.zeros_like(step) if d is None else d, step)
        return torch.where(m, y, x_out), step
    if mode == "residual":
        return b - y
    if mode == "add":
        return z + y
    if mode == "cheb":
        dv = dinv[:, None] if y.ndim == 2 else dinv
        step = c2 * dv * (b - y)
        if c1 is not None:
            step = c1 * d + step
        return x + step, (step if keep_d else None)
    raise ValueError(f"unknown epilogue {mode!r}; expected one of {MODES}")


def check_epilogue(name: str, mode: str, x: torch.Tensor, nrows: int, *,
                   b=None, z=None, dinv=None, d=None, c1=None, row_mask=None,
                   d_out=False) -> None:
    """Validate an epilogue's operands against the SpMV input ``x`` (the
    iterate, for ``halo_spmv``'s Chebyshev step) and its ``nrows`` output
    rows (the kernel's own operands are checked by its module's
    ``check_operands``).  ``d_out``: a first step may take ``d`` as the
    buffer it writes (``halo_spmv``, after the interior launch made it)."""
    out_shape = (nrows,) + tuple(x.shape[1:])
    vectors = {"residual": {"b": b}, "add": {"z": z},
               "cheb": {"b": b, "d": d}}[mode]
    if mode == "cheb":
        if x.shape[0] != nrows:
            raise ValueError(f"{name}: the Chebyshev step needs a square operator, "
                             f"got {nrows} rows and x of {x.shape[0]}")
        if dinv is None or dinv.shape != (nrows,):
            raise ValueError(f"{name}: dinv must be ({nrows},), got "
                             f"{None if dinv is None else tuple(dinv.shape)}")
        vectors["dinv"] = dinv
        if (c1 is not None and d is None) or (c1 is None and d is not None
                                              and not d_out):
            raise ValueError(f"{name}: a step with c1 reads the previous step d, "
                             "a first step (c1 None) takes none")
    for vname, t in vectors.items():
        if t is None:
            if vname == "d":
                continue
            raise ValueError(f"{name}: {mode} needs {vname}")
        want = (nrows,) if vname == "dinv" else out_shape
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {vname} must be {want}, got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {vname}/x dtypes {t.dtype}/{x.dtype}")
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: {vname} must be contiguous on {x.device}")
    if row_mask is not None and (
            row_mask.dtype != torch.int32 or row_mask.shape != (-(-nrows // 32),)
            or row_mask.device != x.device or not row_mask.is_contiguous()):
        raise ValueError(f"{name}: row_mask must be contiguous int32 "
                         f"({-(-nrows // 32)},) on {x.device}, got {row_mask.dtype} "
                         f"{tuple(row_mask.shape)} on {row_mask.device}")
    if d is not None:
        shared = d.untyped_storage().data_ptr()
        if any(t is not None and t.untyped_storage().data_ptr() == shared
               for t in (x, b, dinv)):
            raise ValueError(f"{name}: d is written in place and must not share "
                             "memory with x, b or dinv")
