"""Direct and Krylov comparison solvers.

Counterpart of ``gravo_mg_tpu/solver/direct.py``: the reference's
solverType 0/1 (Eigen/Pardiso sparse factorizations,
multigrid_solver.cpp:1287-1366) as a host factorization (CHOLMOD when
scikit-sparse is importable, SuperLU otherwise), and solverType 4 (Eigen
CG, :1453-1477) as a Jacobi-preconditioned CG on the device whose operator
is the whole LHS in SlicedDiag or SlicedEll layout, so every iteration
launches the ``sliced_diag_spmv`` or ``sliced_spmv`` kernel on a GPU.  On
the card CG's 32-iteration unit between two host checks runs as one CUDA
graph (``device_loop.StepGraph``), as the JAX package runs its chunks of
iterations as one device loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..sparse import numpy_dtype, resolve_device, sliced_layout_from_scipy, spmv
from .device_loop import StepGraph

# The host reads CG's residual norm (a device sync) every CHECK_EVERY
# iterations only; those iterations are one replay of a captured unit.
CHECK_EVERY = 32


def _cholmod_factor():
    """CHOLMOD's ``cholesky`` (scikit-sparse) if importable, else None."""
    try:
        from sksparse.cholmod import cholesky  # type: ignore
    except ImportError:
        return None
    return cholesky


def direct_solve(lhs_csr, rhs: np.ndarray, timing: Optional[dict] = None):
    """Host sparse direct factor + solve: CHOLMOD when available and the
    matrix is SPD, SuperLU otherwise."""
    cholesky = _cholmod_factor()
    t0 = time.perf_counter()
    solve_fn = None
    if cholesky is not None:
        try:
            solve_fn = cholesky(lhs_csr.tocsc())
            backend = "cholmod"
        except Exception:  # noqa: BLE001 — not SPD: SuperLU takes indefinite systems
            solve_fn = None
    if solve_fn is None:
        from scipy.sparse.linalg import splu

        solve_fn = splu(lhs_csr.tocsc()).solve
        backend = "superlu"
    t_factor = (time.perf_counter() - t0) * 1000
    t0 = time.perf_counter()
    x = np.asarray(solve_fn(np.asarray(rhs)))
    t_solve = (time.perf_counter() - t0) * 1000
    if timing is not None:
        timing["direct_factor"] = t_factor
        timing["direct_solve"] = t_solve
        timing["direct_backend"] = backend
    return x


def cg_operator(lhs_csr, dtype=torch.float32):
    """The CG operator: SlicedDiag or SlicedEll, whichever streams fewer
    bytes per apply (the planner's rule, ``sparse.sliced_rule``)."""
    return sliced_layout_from_scipy(lhs_csr, dtype=dtype)


class _CGUnit:
    """CG's device buffers and its ``CHECK_EVERY``-iteration unit for one
    operator layout and right-hand-side shape.  The unit reads and writes
    only these buffers, so a later solve of the same shapes copies its
    operator and preconditioner in (:meth:`load`) and replays the unit an
    earlier solve captured, as the JAX package's jit keeps its compiled
    chunk per shape."""

    def __init__(self, A, dinv, b, jacobi_precond: bool, device):
        self.A = A
        self.dinv = dinv
        self._dinv_b = dinv[:, None] if b.ndim == 2 else dinv
        self.jacobi = jacobi_precond
        # x, r, p and rz are updated in place: the captured unit reads and
        # writes their addresses on every replay.
        self.x = torch.zeros_like(b)
        self.r = torch.zeros_like(b)
        self.p = torch.zeros_like(b)
        self.rz = torch.zeros((), dtype=b.dtype, device=b.device)
        self.graph = StepGraph(self._unit, device, torch.cuda.graph_pool_handle()
                               if device.type == "cuda" else None)

    def load(self, A, dinv) -> None:
        """Copy a host operator of the same layout and shapes, and its
        preconditioner, into the buffers the unit reads."""
        for f in dataclasses.fields(self.A):
            t = getattr(self.A, f.name)
            if torch.is_tensor(t):
                t.copy_(getattr(A, f.name))
        self.dinv.copy_(dinv)

    def precond(self, v):
        return self._dinv_b * v if self.jacobi else v

    def restart(self, r) -> None:
        """Start the recursion from residual ``r`` (written into ``self.r``)."""
        self.r.copy_(r)
        z = self.precond(self.r)
        self.p.copy_(z)
        self.rz.copy_(torch.sum(self.r * z))

    def iteration(self) -> None:
        A, x, r, p, rz = self.A, self.x, self.r, self.p, self.rz
        Ap = spmv(A, p)
        alpha = rz / torch.sum(p * Ap)
        x.addcmul_(p, alpha)
        r.addcmul_(Ap, alpha, value=-1.0)
        # The next iteration's direction.  After a unit's last iteration it
        # runs before the host check, which then ends the recursion or
        # restarts it from x and r alone.
        z = self.precond(r)
        rz_new = torch.sum(r * z)
        p.copy_(z + (rz_new / rz) * p)
        rz.copy_(rz_new)

    def _unit(self) -> None:
        for _ in range(CHECK_EVERY):
            self.iteration()

    def release(self) -> None:
        self.graph.release()


def _unit_key(A, b, jacobi_precond: bool):
    """What a captured unit is specific to: the operator's layout, its
    tensors' shapes and its integer fields, and the right-hand side."""
    fields = tuple(
        (f.name, tuple(v.shape), v.dtype) if torch.is_tensor(v) else (f.name, v)
        for f in dataclasses.fields(A) for v in (getattr(A, f.name),))
    return (type(A).__name__, fields, tuple(b.shape), b.dtype, b.device,
            bool(jacobi_precond))


def cg_solve(
    lhs_csr,
    rhs: np.ndarray,
    tol: float = 1e-4,
    max_iter: int = 10000,
    dtype=torch.float32,
    jacobi_precond: bool = True,
    device="cuda",
    timing: Optional[dict] = None,
    cache: Optional[dict] = None,
):
    """Jacobi-preconditioned conjugate gradients on ``device`` (``"cuda"``
    by default, which raises without a GPU; ``"cpu"`` runs the plain
    PyTorch SpMV).

    Stops at ``||b - A x|| <= tol * ||b||`` or after exactly ``max_iter``
    iterations (one operator apply each).  For an (n, d) right-hand side
    the inner products run over the whole array, as in
    ``jax.scipy.sparse.linalg.cg``.  The host reads the recursive
    residual norm every ``CHECK_EVERY`` iterations only; when it meets
    tol, one more apply checks the true residual, which must meet tol too
    (otherwise the recursion restarts from it).  The ``CHECK_EVERY``
    iterations between two checks are one unit: the first runs eagerly,
    and on the card the later ones are replays of it captured as a CUDA
    graph; a remainder short of a unit (``max_iter`` not a multiple of
    it) runs eagerly.  ``cache`` (optional, a dict the caller keeps, as
    the facade does) holds the unit and its graph for the last operator
    layout and right-hand-side shape, so that a later solve of the same
    shapes replays from its first unit.  ``timing`` (optional) receives
    ``cg_iterations``, ``cg_residual`` (true relative residual of the
    returned iterate in compute dtype, or of the recursion when max_iter
    ran out), ``cg_ms``, ``cg_graph_replays`` and ``cg_capture_ms`` (0
    where this solve captured nothing).
    """
    device = resolve_device(device)
    A = cg_operator(lhs_csr.tocsr(), dtype)
    b = torch.from_numpy(np.ascontiguousarray(rhs, dtype=numpy_dtype(dtype)))
    b = b.to(device)
    dinv = 1.0 / np.maximum(np.asarray(lhs_csr.diagonal()), 1e-30)
    dinv = torch.from_numpy(dinv).to(dtype)
    key = _unit_key(A, b, jacobi_precond)
    unit = cache.get(key) if cache is not None else None
    if unit is None:
        unit = _CGUnit(A.to(device), dinv.to(device), b, jacobi_precond, device)
        if cache is not None:
            for old in cache.values():
                old.release()
            cache.clear()
            cache[key] = unit
    else:
        unit.load(A, dinv)
    A = unit.A
    graph = unit.graph
    captures, replays = graph.captures, graph.replays

    t0 = time.perf_counter()
    x = unit.x
    x.zero_()
    bnorm = float(torch.linalg.vector_norm(b))
    thresh2 = (tol * bnorm) ** 2
    iters = 0
    res = 0.0
    if bnorm > 0.0:
        unit.restart(b)
        r = unit.r
        while iters < max_iter:
            n = min(CHECK_EVERY, max_iter - iters)
            if n == CHECK_EVERY:
                graph.run(1)
            else:
                for _ in range(n):
                    unit.iteration()
            iters += n
            rr = float(torch.sum(r * r))
            res = rr ** 0.5 / bnorm
            if rr <= thresh2:
                r.copy_(b - spmv(A, x))
                rr = float(torch.sum(r * r))
                res = rr ** 0.5 / bnorm
                if rr <= thresh2 or iters == max_iter:
                    break
                # the recursion drifted: restart it from the true residual
                unit.restart(r)
    if timing is not None:
        timing["cg_iterations"] = float(iters)
        timing["cg_residual"] = res
        timing["cg_ms"] = (time.perf_counter() - t0) * 1000
        timing["cg_graph_replays"] = float(graph.replays - replays)
        timing["cg_capture_ms"] = graph.capture_ms if graph.captures > captures else 0.0
    out = x.cpu().numpy()
    if cache is None:
        unit.release()
    return out
