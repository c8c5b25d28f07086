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
"""

from __future__ import annotations

import torch

MODES = ("plain", "residual", "add", "cheb")


def epilogue_plain(mode: str, y: torch.Tensor, *, b=None, z=None, dinv=None,
                   x=None, d=None, c1=None, c2=None, keep_d=True):
    """Apply ``mode``'s torch ops to the SpMV result ``y``.  Returns ``y``,
    ``b - y`` or ``z + y``, and for ``"cheb"`` the pair ``(x + d_new,
    d_new)``, ``d_new`` None where ``keep_d`` is false; ``c1`` is None on
    a first step (``d`` is then not read)."""
    if mode == "plain":
        return y
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
                   b=None, z=None, dinv=None, d=None, c1=None) -> None:
    """Validate an epilogue's operands against the SpMV input ``x`` and
    its ``nrows`` output rows (the kernel's own operands are checked by
    its module's ``check_operands``)."""
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
        if (c1 is None) != (d is None):
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
    if d is not None:
        shared = d.untyped_storage().data_ptr()
        if any(t is not None and t.untyped_storage().data_ptr() == shared
               for t in (x, b, dinv)):
            raise ValueError(f"{name}: d is written in place and must not share "
                             "memory with x, b or dinv")
