"""Residual stopping criteria.

Counterpart of ``gravo_mg_tpu/solver/residual.py``; parity with
``residualCheck`` (gravomg/src/multigrid_solver.cpp:1228-1277): type 0
relative l2, type 1 M^-1-norm, type 2 M-norm (the paper's default), type 3
absolute; always the max over RHS columns.  The solve evaluates the
numerator on the deflated right-hand side and the denominator once from
the original one.
"""

from __future__ import annotations

import torch

from ..sparse import spmv, spmv_residual


def _as_2d(v):
    return v[:, None] if v.ndim == 1 else v


def residual_numerator(A, M, Minv_diag, b, x, criteria: int):
    """Per-column residual norms (numerators) for each criterion.  The
    residual is ``b - A x``, one SpMV launch on the sliced layouts; the JAX
    package forms ``A x - b``, which is its exact negation, and every
    criterion is even in r."""
    r = _as_2d(spmv_residual(A, x, b))
    if criteria == 0:
        return torch.linalg.vector_norm(r, dim=0)
    if criteria == 1:
        return torch.sqrt(torch.sum(r * (Minv_diag[:, None] * r), dim=0))
    if criteria == 2:
        return torch.sqrt(torch.sum(r * spmv(M, r), dim=0))
    if criteria == 3:
        return torch.linalg.vector_norm(r).reshape(1)
    raise ValueError(f"unknown stopping criteria {criteria}")


def residual_denominator(M, Minv_diag, b, criteria: int):
    """Per-column denominators from the original RHS."""
    b2 = _as_2d(b)
    if criteria == 0:
        return torch.linalg.vector_norm(b2, dim=0).clamp_min(1e-30)
    if criteria == 1:
        return torch.sqrt(
            torch.sum(b2 * (Minv_diag[:, None] * b2), dim=0)
        ).clamp_min(1e-30)
    if criteria == 2:
        return torch.sqrt(torch.sum(b2 * spmv(M, b2), dim=0)).clamp_min(1e-30)
    if criteria == 3:
        return torch.ones((1,), dtype=b2.dtype, device=b2.device)
    raise ValueError(f"unknown stopping criteria {criteria}")


def residual_norm(A, M, Minv_diag, b, x, criteria: int = 2):
    """Reference-style residual: max over RHS columns of num/den."""
    num = residual_numerator(A, M, Minv_diag, b, x, criteria)
    den = residual_denominator(M, Minv_diag, b, criteria)
    return torch.max(num / den)
