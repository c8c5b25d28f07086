"""The yardstick's peaks and the bytes a cycle's sparse applies need.

Bytes are format-neutral: each apply of an operator with ``nnz`` stored
nonzeros reads every nonzero once as an int32 column and a value, x once and
writes y once, ``nnz * (4 + itemsize) + (nrows + ncols) * d * itemsize``,
whatever layout or kernel does the work.  The operators are recomputed here
with SciPy from the inputs and the hierarchy's public prolongation
matrices; no launch counter of the program is read.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "flops_f32": 67e12, "flops_f64": 34e12},
}
DEFAULT_DEVICE = "NVIDIA H100 80GB HBM3"


def hbm_bytes_per_s(device_name: str) -> float:
    return PEAKS.get(device_name, PEAKS[DEFAULT_DEVICE])["hbm_bytes_per_s"]


def apply_bytes(nnz: int, nrows: int, ncols: int, d: int, itemsize: int) -> int:
    """Format-neutral bytes of one apply ``y = A x`` with ``d`` columns."""
    return nnz * (4 + itemsize) + (nrows + ncols) * d * itemsize


def cycle_applies(levels: int, pre: int, post: int) -> int:
    """Sparse applies of one V-cycle and its stopping criterion over
    ``levels`` levels above the coarsest (see :func:`cycle_bytes`)."""
    return levels * (pre + 1 + post + 2) + 2


def _pattern(A):
    A = abs(A.tocsr()).astype(np.float64)
    A.eliminate_zeros()
    return A


def galerkin_operators(lhs, prolongations):
    """``[A_0, ..., A_L]`` and ``[U_0, ..., U_{L-1}]`` as patterns:
    ``A_{k+1} = U_k^T A_k U_k`` on absolute values, so that no entry cancels
    (the structural nonzeros of the program's f64 Galerkin chain)."""
    A = _pattern(lhs)
    U = [_pattern(u) for u in prolongations]
    chain = [A]
    for u in U:
        A = (u.T.tocsr() @ (A @ u)).tocsr()
        A.eliminate_zeros()
        chain.append(A)
    return chain, U


def cycle_bytes(chain, U, M, d: int, itemsize: int, pre: int, post: int,
                cycle_type: int = 0) -> tuple:
    """``(bytes per cycle, bytes per solve)`` of the sparse applies.

    A V-cycle applies at every level k above the coarsest ``pre`` smoothing
    steps, one residual and ``post`` smoothing steps of ``A_k``, then one
    ``U_k^T`` and one ``U_k``; the coarsest level is a dense solve.  The
    stopping criterion adds one ``A_0`` and one ``M`` apply a cycle, and the
    criterion's denominator one ``M`` apply a solve."""
    if cycle_type != 0:
        raise ValueError("only the V-cycle is counted")
    per_cycle = 0
    for k, u in enumerate(U):
        A = chain[k]
        n = A.shape[0]
        per_cycle += (pre + 1 + post) * apply_bytes(A.nnz, n, n, d, itemsize)
        per_cycle += apply_bytes(u.nnz, u.shape[1], u.shape[0], d, itemsize)
        per_cycle += apply_bytes(u.nnz, u.shape[0], u.shape[1], d, itemsize)
    n0 = chain[0].shape[0]
    m_bytes = apply_bytes(M.nnz, n0, n0, d, itemsize)
    per_cycle += apply_bytes(chain[0].nnz, n0, n0, d, itemsize) + m_bytes
    return per_cycle, m_bytes
