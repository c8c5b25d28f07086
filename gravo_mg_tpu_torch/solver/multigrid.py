"""Multigrid solve path: Galerkin reduction, cycles, outer iteration.

Counterpart of ``gravo_mg_tpu/solver/multigrid.py`` (the reference's
``MultigridSolver::solve``, gravomg/src/multigrid_solver.cpp:1279-1485):

* setup is host work in f64: the scipy Galerkin chain
  ``Abar[k+1] = U_k^T Abar[k] U_k``, per-level slot layouts, diagonals,
  spectral bounds and the regularized coarse inverse; the device receives
  only the finished layout tensors;
* V/F/W cycles (reference ``:1059-1192``) recurse over the levels in
  eager torch: degree-4 Chebyshev smoothing, the residual and the
  prolongation's add, each one SpMV launch with its epilogue on the
  sliced layouts (``sparse.cheb_step``, ``spmv_residual``, ``spmv_add``),
  a coarse inverse apply with one refinement step;
* the iterate-to-tolerance loop either runs on the host, one cycle ahead
  of the residual it waits for (``mode="traced"``), or is the JAX
  package's ``fused_solve``: its ``while_loop`` as one CUDA graph, a
  conditional WHILE node around the captured cycle and stop test, one
  launch and one host wait per solve (``mode="fused"``,
  :class:`FusedLoop`).  Both return the first iterate that meets tol.

Compute runs in the context's dtype (f32 by default); the exact
constant-mode deflation runs in f64 on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..enums import CycleType, Smoother
from ..hierarchy.builder import Hierarchy
from ..sparse import (
    ShuffleTransfer,
    SlicedDiag,
    SlicedEll,
    numpy_dtype,
    resolve_device,
    sliced_from_scipy,
    sliced_pattern,
    sliced_rule,
    spmv_residual,
)
from ..utils.profiler import span
from .device_loop import StepGraph
from .residual import residual_denominator, residual_numerator
from .smoothers import chebyshev, jacobi


@dataclasses.dataclass
class LevelOps:
    """Per-level operator bundle used by the cycle."""

    A: object                # SlicedDiag | SlicedEll (| DiagEll)
    diag_inv: torch.Tensor
    lam_max: float
    U: object                # ShuffleTransfer | Prolongation

    def to(self, device) -> "LevelOps":
        return LevelOps(
            self.A.to(device), self.diag_inv.to(device), self.lam_max,
            self.U.to(device),
        )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Static cycle configuration (same fields and defaults as the
    reference; see its SolverConfig for the smoother tuning history)."""

    cycle_type: int = int(CycleType.V)
    pre_iters: int = 4
    post_iters: int = 4
    smoother: int = int(Smoother.CHEBYSHEV)
    jacobi_omega: float = 2.0 / 3.0
    # Chebyshev smoothing band [lam_max/cheb_ratio, cheb_safety*lam_max].
    cheb_ratio: float = 12.0
    cheb_safety: float = 1.1
    num_levels: int = 0
    # Near-singular systems only: project the constant mode out of each
    # coarse correction (the rank-1 regularization of the coarse inverse
    # leaks an exact constant into it).
    coarse_null_project: bool = False


def _smooth(cfg: SolverConfig, ops: LevelOps, b, x, iters: int):
    if iters <= 0:
        return x
    if cfg.smoother == int(Smoother.JACOBI):
        return jacobi(ops.A, ops.diag_inv, b, x, iters, cfg.jacobi_omega)
    lam_max = cfg.cheb_safety * ops.lam_max
    lam_min = ops.lam_max / cfg.cheb_ratio
    return chebyshev(ops.A, ops.diag_inv, b, x, iters, lam_min, lam_max)


@contextlib.contextmanager
def _full_fp32_matmul():
    """Keep cuBLAS off TF32 (about 3 significant digits) for the coarse
    products even where the process enabled it: the refinement step in
    _coarse_solve would lose its accuracy.  A CUDA graph keeps the GEMM
    it captured, and the capture runs inside this context too, so a
    fused solve replays the full-f32 GEMM whatever the flag is later."""
    prev = torch.backends.cuda.matmul.allow_tf32
    if prev:
        torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        if prev:
            torch.backends.cuda.matmul.allow_tf32 = True


def _coarse_solve(coarse, rc, null_project: bool = False):
    """Coarsest-level solve: apply the host-precomputed (regularized)
    inverse, then one iterative-refinement step ``e += Ainv (rc - Ad e)``.
    ``coarse = (Ainv, Ad)`` in compute dtype."""
    Ainv, Ad = coarse
    one_d = rc.ndim == 1
    rhs = (rc[:, None] if one_d else rc).to(Ainv.dtype)
    with _full_fp32_matmul():
        e = Ainv @ rhs
        e = e + Ainv @ (rhs - Ad @ e)
    if null_project:
        e = e - e.mean(dim=0, keepdim=True)
    e = e.to(rc.dtype)
    return e[:, 0] if one_d else e


def _coarse_correction(cfg: SolverConfig, coarse, rc):
    """``coarse`` is ``(Ainv, Ad)`` or a callable ``rc -> e`` (the halo
    solver's replicated coarse solve)."""
    if callable(coarse):
        return coarse(rc)
    return _coarse_solve(coarse, rc, cfg.coarse_null_project)


def _cycle(cfg: SolverConfig, levels, coarse, b, x, k: int, kind: int):
    """Recursive cycle (kind: 0=V, 1=F, 2=W)."""
    ops = levels[k]
    x = _smooth(cfg, ops, b, x, cfg.pre_iters)
    r = spmv_residual(ops.A, x, b)
    rc = ops.U.restrict(r)
    if k == cfg.num_levels - 1:
        e = _coarse_correction(cfg, coarse, rc)
    else:
        e = _cycle(cfg, levels, coarse, rc, torch.zeros_like(rc), k + 1, kind)
    x = ops.U.prolong_add(e, x)
    x = _smooth(cfg, ops, b, x, cfg.post_iters)
    if kind != int(CycleType.V):
        # F- and W-cycles run a second correction pass
        # (multigrid_solver.cpp:1091-1192); F recurses into V, W into W.
        r = spmv_residual(ops.A, x, b)
        rc = ops.U.restrict(r)
        if k == cfg.num_levels - 1:
            e = _coarse_correction(cfg, coarse, rc)
        else:
            kind2 = int(CycleType.V) if kind == int(CycleType.F) else kind
            e = _cycle(
                cfg, levels, coarse, rc, torch.zeros_like(rc), k + 1, kind2
            )
        x = ops.U.prolong_add(e, x)
        x = _smooth(cfg, ops, b, x, cfg.post_iters)
    return x


def cycle_step(cfg: SolverConfig, levels, coarse, b, x):
    """One cycle of the configured type from the finest level."""
    return _cycle(cfg, levels, coarse, b, x, 0, cfg.cycle_type)


@dataclasses.dataclass
class _LoopState:
    """The fused loop's static buffers: the captured cycle reads and
    writes these addresses in every body of the loop."""

    b: torch.Tensor
    x: torch.Tensor
    den: torch.Tensor
    tol: torch.Tensor      # 0-d, compute dtype
    res: torch.Tensor      # 0-d, compute dtype
    it: torch.Tensor       # 0-d int64
    trace: torch.Tensor    # (max_iter,), inf where unused
    slots: torch.Tensor    # arange(max_iter)
    more: torch.Tensor     # 0-d bool: the loop's cond after the last cycle


def _loop_body(cfg, levels, coarse, numerator, max_iter, st):
    """The body of the JAX ``fused_solve`` loop, in place on the loop's
    buffers, and its ``cond`` written to ``st.more`` for the WHILE node.
    ``numerator(b, x)`` gives the per-column residual numerators
    (:func:`residual.residual_numerator` on one device, the all-reduced
    one on a halo mesh).  Nothing here reads the card from the host, so
    the step can be captured."""
    x_new = cycle_step(cfg, levels, coarse, st.b, st.x)
    r_new = torch.max(numerator(st.b, x_new) / st.den)
    st.x.copy_(x_new)
    st.trace.copy_(torch.where(st.slots == st.it, r_new, st.trace))
    st.res.copy_(r_new)
    st.it.add_(1)
    torch.logical_and(st.res > st.tol, st.it < max_iter, out=st.more)


class FusedLoop:
    """The JAX package's ``fused_solve`` (gravo_mg_tpu/solver/multigrid.py)
    on the card: its ``while_loop`` body (:func:`_loop_body`) captured
    once as a CUDA graph and run by :meth:`device_loop.StepGraph.loop`
    under a conditional WHILE node that reads the body's stop flag, so a
    warm solve is one graph launch and one host wait.  On the CPU the
    same body runs eagerly while the host reads the flag.

    One loop serves one (right-hand-side shape, criteria, max_iter) of
    one set of operators; ``tol`` is a value in a buffer.  The result is
    JAX's: the first iterate that meets tol, its ``iters``, ``res`` and
    ``trace[:iters]``.  ``levels`` and ``coarse`` are the cycle's
    (:func:`cycle_step`), ``numerator(b, x)`` the residual criterion's
    per-column numerators: the single-device loop and the halo solver's
    (``parallel/halo.py``) differ only in these.
    """

    def __init__(self, cfg, levels, coarse, numerator, max_iter: int,
                 pool=None):
        self._step_args = (cfg, levels, coarse, numerator, int(max_iter))
        self.max_iter = int(max_iter)
        self.pool = pool
        self.state: Optional[_LoopState] = None
        self.graph: Optional[StepGraph] = None

    def run(self, b, x0, den, tol: float):
        """Copy ``b``, ``x0`` and ``den`` into the static buffers and loop
        to ``tol``.  Returns ``(x, iters, res, trace, host reads, graph
        launches)``, with ``x`` and ``trace`` copied out of the buffers
        (the next run overwrites them)."""
        st = self.state
        if st is None:
            it = torch.zeros((), dtype=torch.int64, device=b.device)
            st = self.state = _LoopState(
                b=b.clone(), x=x0.clone(), den=den.clone(),
                tol=torch.zeros((), dtype=b.dtype, device=b.device),
                res=torch.zeros((), dtype=b.dtype, device=b.device), it=it,
                trace=torch.zeros((self.max_iter,), dtype=b.dtype, device=b.device),
                slots=torch.arange(self.max_iter, device=b.device),
                more=torch.zeros((), dtype=torch.bool, device=b.device))
            self.graph = StepGraph(
                functools.partial(_loop_body, *self._step_args, st),
                b.device, self.pool)
        else:
            st.b.copy_(b)
            st.x.copy_(x0)
            st.den.copy_(den)
        st.tol.fill_(tol)
        st.res.fill_(math.inf)
        st.it.zero_()
        st.trace.fill_(math.inf)
        launches = self.graph.launches
        iters, reads = 0, 1
        # the cond before the first body, known on the host
        if self.max_iter > 0 and math.inf > tol:
            st.more.fill_(True)
            iters, reads = self.graph.loop(st.more, st.it)
        return (st.x.clone(), iters, float(st.res), st.trace[:iters].tolist(),
                reads, self.graph.launches - launches)

    def release(self) -> None:
        if self.graph is not None:
            self.graph.release()


def release_loops(loops: dict, device: torch.device) -> None:
    """Free the WHILE graphs and captures of ``loops`` (a context's cache
    of :class:`FusedLoop`, emptied here), then hand their memory pool back
    to the device: PyTorch keeps a released graph pool reserved until
    ``empty_cache``, so a context that recaptures after every LHS update
    would otherwise reserve one more pool each time."""
    for loop in loops.values():
        loop.release()
    released = bool(loops)
    loops.clear()
    if released and device.type == "cuda":
        torch.cuda.empty_cache()


def loop_timing(loop: FusedLoop, reads: int, launches: int) -> dict:
    """A fused solve's timing keys: host reads and WHILE-graph launches of
    this solve; captures, capture and build ms and graph pool MiB of its
    loop."""
    g = loop.graph
    return dict(host_reads=float(reads), graph_launches=float(launches),
                graph_captures=float(g.captures), graph_capture_ms=g.capture_ms,
                graph_build_ms=g.build_ms, graph_pool_mib=g.pool_mib)


def _numerator(levels, M, Minv_diag, criteria: int):
    """The single-device residual numerator ``(b, x) -> (d,)``."""
    return functools.partial(residual_numerator, levels[0].A, M, Minv_diag,
                             criteria=int(criteria))


def fused_solve(cfg: SolverConfig, levels, coarse, M, Minv_diag, b, x0, den,
                tol: float, criteria: int, max_iter: int, pool=None):
    """The JAX package's ``fused_solve`` with its arguments: ``(x, iters,
    res, trace)``, ``trace`` holding the ``iters`` residuals."""
    x, iters, res, trace, *_ = FusedLoop(
        cfg, levels, coarse, _numerator(levels, M, Minv_diag, criteria),
        max_iter, pool,
    ).run(b, x0, den, tol)
    return x, iters, res, trace


# Row sums below DEFLATION_FLOOR * n * eps64 * mean|diag A| in total are
# assembly roundoff, whatever their signs.
DEFLATION_FLOOR = 16.0


def deflation_denominator(row_sums: np.ndarray,
                          diag_scale: Optional[float] = None) -> Optional[float]:
    """The constant-mode deflation's gate and denominator: ``sum(A @ 1)``
    (f64) where the deflation applies, else None.  A constant of the LHS.

    Deflate iff the row-sum vector is sign-coherent,
    ``|sum(row_sums)| > 0.1 * sum(|row_sums|)``, and, when the matrix
    scale ``diag_scale`` (mean |diag A|) is given, above roundoff:
    ``sum(|row_sums|) > DEFLATION_FLOOR * n * eps64 * diag_scale``.  A
    genuine near-null regularization (``eta * M @ 1``) passes both at any
    mesh scale.  Random-sign assembly roundoff fails the first gate, and
    roundoff of one sign (a singular operator off by a few ulps per row,
    where alpha would be astronomically large) fails the second.
    """
    denom = float(row_sums.sum())
    abs_sum = float(np.abs(row_sums).sum())
    floor = 0.0
    if diag_scale is not None:
        floor = (DEFLATION_FLOOR * row_sums.shape[0]
                 * np.finfo(np.float64).eps * float(diag_scale))
    if abs_sum > floor and abs(denom) > 0.1 * abs_sum:
        return denom
    return None


def deflation_alpha(row_sums: np.ndarray, rhs2: np.ndarray,
                    diag_scale: Optional[float] = None) -> np.ndarray:
    """Exact rank-1 constant-mode deflation coefficients (f64, (d,)):
    ``sum(b) / sum(A @ 1)`` per column where :func:`deflation_denominator`
    lets the deflation apply, else zeros."""
    denom = deflation_denominator(row_sums, diag_scale)
    if denom is None:
        return np.zeros(rhs2.shape[1])
    return np.asarray(rhs2.sum(axis=0) / denom, dtype=np.float64)


def device_deflation(rhs64: torch.Tensor, row_sums: torch.Tensor,
                     denom: Optional[float], dtype):
    """The constant-mode deflation on the rhs's device, in f64:
    ``(alpha, rhs_c, b)``.  ``rhs64`` is the (n,) or (n, d) f64 rhs,
    ``row_sums`` the (n,) f64 ``A @ 1`` and ``denom`` the LHS's
    :func:`deflation_denominator`; alpha is the (d,) f64 ``sum(rhs) /
    denom`` per column (zeros where ``denom`` is None), ``rhs_c`` the rhs
    in the compute dtype and ``b = rhs_c - alpha * (A @ 1)``, formed in
    f64 and then rounded."""
    r2 = rhs64[:, None] if rhs64.ndim == 1 else rhs64
    alpha = r2.new_zeros(r2.shape[1]) if denom is None else r2.sum(0) / denom
    rhs_c = rhs64.to(dtype)
    rs = row_sums if rhs64.ndim == 1 else row_sums[:, None]
    return alpha, rhs_c, (rhs_c.double() - alpha * rs).to(dtype)


def _drop_zeros(U_csr):
    """U without its explicit zero weights (in place).  The comparison
    hierarchies pad their fixed-width rows with (column 0, weight 0), which
    would make row 0 of U^T (and row/column 0 of the Galerkin chain) dense:
    a shuffle layout padded thousands of times over, so the transfers would
    leave the SpMV kernels.  The operators' values are unchanged."""
    U_csr.eliminate_zeros()
    return U_csr


def galerkin_chain_scipy(lhs_csr, U_csr_list) -> list:
    """Host Galerkin chain ``Abar[k+1] = U_k^T Abar[k] U_k`` in f64.

    The output pattern is structural (independent of values), so
    same-pattern LHS updates reuse every downstream layout.  Returns
    ``[A0, Abar1, ..., Abar_L]`` csr.
    """
    A = lhs_csr.tocsr().astype(np.float64)
    A.sum_duplicates()
    A.sort_indices()
    chain = [A]
    for U in U_csr_list:
        A = (U.T.tocsr() @ (A @ U)).tocsr()
        A.sum_duplicates()
        A.sort_indices()
        chain.append(A)
    return chain


def lambda_max_host(A_csr, diag_inv: np.ndarray, iters: int = 15,
                    seed: int = 0) -> float:
    """Spectral radius of D^-1 A by host power iteration."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(A_csr.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = diag_inv * (A_csr @ v)
        lam = np.linalg.norm(w)
        v = w / max(lam, 1e-30)
    return float(lam)


def coarse_inverse_host(A_coarse_csr, null_fix: bool):
    """(Ainv, Ad) f64 numpy: the regularized dense coarsest operator ``Ad``,
    for the refinement step in _coarse_solve, and its inverse from a dense
    Cholesky factor (host LAPACK).

    ``null_fix`` adds sigma * (1 1^T)/n, which moves only the near-null
    constant eigenvalue of near-singular systems (the outer solve deflates
    that mode exactly); a tiny relative diagonal shift plays the role of
    the reference's LDLT robustness (min_quad_with_fixed_mg.cpp:31-36).
    """
    import scipy.linalg

    Ad = np.asarray(A_coarse_csr.todense(), dtype=np.float64)
    nc = Ad.shape[0]
    diag_scale = float(np.mean(np.abs(np.diag(Ad))))
    Ad[np.diag_indices(nc)] += 1e-12 * diag_scale
    if null_fix:
        Ad += diag_scale / nc
    Ainv = scipy.linalg.cho_solve((np.linalg.cholesky(Ad), True), np.eye(nc))
    return Ainv, Ad


def _layout_counts(plans, chain, transfers, U_csr) -> dict:
    """The planner's layout counters, set once per context: stored slots
    (padding included) and structural nonzeros over every level operator's
    layout and both directions of every transfer, and how many levels were
    planned as SlicedDiag and as SlicedEll."""
    slots = nnz = 0
    for plan, A in zip(plans, chain):
        nnz += A.nnz
        slots += int(plan[1][0][-1])   # a plan's first array is its slice_ptr
    for t, Ucsr in zip(transfers, U_csr):
        nnz += 2 * Ucsr.nnz
        slots += (int(t.U.col.numel()) + int(t.UT.col.numel())
                  if isinstance(t, ShuffleTransfer) else 2 * t.host_cols.size)
    tags = [plan[0] for plan in plans]
    return {"layout_slots": float(slots), "layout_nnz": float(nnz),
            "levels_sliced_diag": float(tags.count("sdiag")),
            "levels_sliced_ell": float(tags.count("sliced"))}


# timing keys only a fused solve sets
_FUSED_TIMING = ("trace_timestamps_synthetic", "host_reads", "graph_launches",
                 "graph_captures", "graph_capture_ms", "graph_build_ms",
                 "graph_pool_mib")


class MultigridSolveContext:
    """Everything reusable across solves for one (hierarchy, LHS pattern):
    chain patterns, slot layouts, device level operators, coarse inverse.

    ``diag_min_groups``: levels with at least this many 128-row groups may
    be planned as SlicedDiag, where that streams fewer bytes per apply than
    SlicedEll (the reference reads its DiagEll gate from the environment).
    ``device`` defaults to ``"cuda"``, which raises without a GPU; pass
    ``"cpu"`` for the plain PyTorch SpMVs.
    """

    def __init__(
        self,
        hierarchy: Hierarchy,
        lhs_csr,
        mass_csr,
        cfg: SolverConfig,
        dtype=torch.float32,
        device="cuda",
        diag_min_groups: int = 4096,
    ):
        self.hierarchy = hierarchy
        self.cfg = dataclasses.replace(cfg, num_levels=hierarchy.num_levels)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.diag_min_groups = int(diag_min_groups)
        self.timing: dict = {}
        self.dispatched = 0    # cycles the last solve sent to the device
        # mode="fused": one FusedLoop per (cols, criteria, max_iter), as the
        # JAX halo solve keys its program; their graphs share one pool.
        self._fused: dict = {}
        self._graph_pool = None
        self._events = None    # the loop's CUDA events, made at its first solve
        self._fresh = True     # values set up since the last solve

        t0 = time.perf_counter()
        self.lhs_csr = lhs_csr.tocsr()
        self._analyze_lhs()
        self.timing["setup_analyze"] = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        self.mass_csr = mass_csr.tocsr()
        self.M = sliced_from_scipy(mass_csr, dtype=dtype).to(self.device)
        minv = 1.0 / np.maximum(np.asarray(mass_csr.diagonal()), 1e-30)
        self.Minv_diag = torch.from_numpy(minv).to(self.device, dtype)
        self.timing["setup_mass"] = (time.perf_counter() - t0) * 1000

        # --- pattern discovery: f64 scipy Galerkin chain ------------------
        t0 = time.perf_counter()
        self.U_csr = [_drop_zeros(lvl.U.to_scipy()) for lvl in hierarchy.levels]
        self.timing["setup_u_host"] = (time.perf_counter() - t0) * 1000
        t1 = time.perf_counter()
        chain = galerkin_chain_scipy(self.lhs_csr, self.U_csr)
        self.timing["setup_chain"] = (time.perf_counter() - t1) * 1000
        self.timing["plan_build"] = (time.perf_counter() - t0) * 1000

        # --- slot layouts (pattern-only, reused across LHS values) --------
        # Per-level work is numpy array passes, which release the GIL.
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            self._plans = list(pool.map(self._plan_level, chain[:-1]))
        self.timing["setup_shuffle_layout"] = (time.perf_counter() - t0) * 1000
        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            self.transfers = tuple(
                pool.map(self._build_transfer, enumerate(self.U_csr))
            )
        self.timing["setup_transfers"] = (time.perf_counter() - t1) * 1000
        self.timing["shuffle_plan"] = (time.perf_counter() - t0) * 1000
        self.timing.update(_layout_counts(self._plans, chain, self.transfers,
                                          self.U_csr))

        # each level's csr data position per stored entry (nnz = padding,
        # an appended zero): the per-solve value fill is one gather
        t0 = time.perf_counter()
        self._csr_src = [plan[2] for plan in self._plans]
        self.timing["setup_csr_src"] = (time.perf_counter() - t0) * 1000
        self._dev_pattern: dict = {}

        # --- values: fill layouts, spectral bounds, coarse inverse, upload
        self._reduce_and_upload(chain)

    def _plan_level(self, A_csr):
        """Per-level sparse-layout choice: a tagged plan tuple ``(tag,
        pattern arrays, pos, extra)`` from :func:`sparse.sliced_pattern`,
        ``pos`` mapping each stored entry to its csr data position (nnz =
        padding).

        Every level gets the SlicedEll layout (``"sliced"``, extra = threads
        per row), except that a level with >= ``diag_min_groups`` row groups
        of 128 gets the SlicedDiag layout derived from it (``"sdiag"``,
        extra = widest slice) where one apply then streams fewer bytes
        (:func:`sparse.sliced_rule`).
        """
        slice_ptr, col, pos = sliced_pattern(A_csr)
        tag, runs, extra = sliced_rule(slice_ptr, col, pos != A_csr.nnz,
                                       A_csr.shape,
                                       numpy_dtype(self.dtype).itemsize,
                                       self.diag_min_groups)
        arrays = (slice_ptr,) + runs if tag == "sdiag" else (slice_ptr, col)
        return (tag, arrays, pos, extra)

    def _level_tensors(self, k, pattern, A):
        """Device tensors of level k's operator: its pattern arrays,
        uploaded once (they do not change with the LHS values), and its
        stored values, gathered on the host in compute dtype."""
        table = np.append(A.data, 0.0).astype(numpy_dtype(self.dtype), copy=False)
        v = torch.from_numpy(table[self._csr_src[k]]).to(self.device)
        if k not in self._dev_pattern:
            self._dev_pattern[k] = tuple(
                torch.from_numpy(a).to(self.device) for a in pattern
            )
        return self._dev_pattern[k] + (v,)

    def _build_transfer(self, k_and_Ucsr):
        """SlicedEll pair for level k's U/U^T, or the hierarchy's
        Prolongation (gather + index_add) where either layout would store
        beyond max(24 nnz, 2^24) entries (a slice pads to its longest
        row, so a layout stores at most 32 nnz)."""
        k, Ucsr = k_and_Ucsr
        cap = max(24 * Ucsr.nnz, 1 << 24)
        U = sliced_from_scipy(Ucsr, dtype=self.dtype, size_cap=cap)
        UT = (
            sliced_from_scipy(Ucsr.T.tocsr(), dtype=self.dtype, size_cap=cap)
            if U is not None else None
        )
        if U is None or UT is None:
            return self.hierarchy.levels[k].U.to(self.device, self.dtype)
        return ShuffleTransfer(U, UT).to(self.device)

    def _reduce_and_upload(self, chain):
        """Value-dependent half of setup: per-level layout values,
        diagonals, lambda_max, coarse inverse — host-computed, uploaded."""
        with span(self.timing, "reduction", host_only=False):
            # The host state below is kept for the halo partitioner
            # (parallel/halo.py): the f64 chain, diagonals, spectral bounds and
            # the coarse inverse.
            self.chain_csr = chain
            self._host_diag_inv = []
            self.host_lam = []
            levels = []
            t_values = t_spec = 0.0
            npdt = numpy_dtype(self.dtype)
            for k in range(self.cfg.num_levels):
                A = chain[k]
                t1 = time.perf_counter()
                diag = A.diagonal()
                diag_inv_np = 1.0 / np.where(np.abs(diag) > 1e-30, diag, 1.0)
                t2 = time.perf_counter()
                with span(None, "update_spectral", host_only=True):
                    lam = lambda_max_host(A, diag_inv_np)
                t3 = time.perf_counter()
                plan = self._plans[k]
                if plan[0] == "sdiag":
                    ptr_t, base_t, delta_t, wp_t, wc_t, v_t = self._level_tensors(
                        k, plan[1], A)
                    A_dev = SlicedDiag(ptr_t, base_t, delta_t, v_t, wp_t, wc_t,
                                       A.shape[0], A.shape[1], int(A.nnz), plan[3])
                else:
                    ptr_t, col_t, v_t = self._level_tensors(k, plan[1], A)
                    A_dev = SlicedEll(ptr_t, col_t, v_t, A.shape[0], A.shape[1],
                                      int(A.nnz), plan[3])
                diag_inv = torch.from_numpy(diag_inv_np).to(self.device, self.dtype)
                self._host_diag_inv.append(diag_inv_np)
                self.host_lam.append(lam)
                # lam_max rounded to the compute dtype, as the reference stores it
                levels.append(LevelOps(
                    A_dev, diag_inv, float(np.asarray(lam, npdt)), self.transfers[k]
                ))
                t_values += (t2 - t1) + (time.perf_counter() - t3)
                t_spec += t3 - t2
            self.levels = tuple(levels)
            self.timing["setup_values"] = t_values * 1000
            self.timing["setup_spectral"] = t_spec * 1000
            with span(self.timing, "setup_coarse_factor", host_only=False):
                with span(None, "update_coarse_factor", host_only=True):
                    Ainv, Ad = coarse_inverse_host(chain[-1], self.near_singular)
                self._host_coarse_inv = (Ainv, Ad)
                self.coarse_op = (
                    torch.from_numpy(Ainv).to(self.device, self.dtype),
                    torch.from_numpy(Ad).to(self.device, self.dtype),
                )

    def _analyze_lhs(self):
        """f64 row sums (= A @ 1), the deflation's gate and near-singularity
        detection, for the exact constant-mode deflation (see solve()) and
        the coarse nullspace fix (see coarse_inverse_host)."""
        self.row_sums = np.asarray(
            self.lhs_csr.sum(axis=1), dtype=np.float64
        ).ravel()
        n = self.lhs_csr.shape[0]
        self.diag_scale = float(np.abs(self.lhs_csr.diagonal()).mean())
        self.deflation_denom = deflation_denominator(self.row_sums,
                                                     self.diag_scale)
        self.near_singular = (
            abs(float(self.row_sums.sum())) < 1e-6 * self.diag_scale * n
        )
        self.cfg = dataclasses.replace(
            self.cfg, coarse_null_project=self.near_singular
        )
        self._row_sums_dev = torch.from_numpy(self.row_sums).to(self.device)

    def update_lhs(self, lhs_csr):
        """Re-run the value-only reduction for a new LHS with the same
        sparsity pattern: layouts and transfers are reused; the chain,
        value fills and the coarse inverse recompute."""
        with span(self.timing, "plan_build", host_only=False):
            self.release_graphs()
            self.lhs_csr = lhs_csr.tocsr()
            self._analyze_lhs()
            with span(None, "update_galerkin", host_only=True):
                chain = galerkin_chain_scipy(self.lhs_csr, self.U_csr)
        self._reduce_and_upload(chain)
        self._fresh = True

    def release_graphs(self):
        """Drop the fused solves' loops and graphs, and so their memory
        pool.  A graph holds the level operators' addresses and bakes in
        lam_max and the Chebyshev coefficients, which are Python floats:
        kept across an LHS update it would solve the old system without
        any error."""
        release_loops(self._fused, self.device)
        self._graph_pool = None

    def _fused_loop(self, cols, criteria: int, max_iter: int) -> FusedLoop:
        key = (cols, criteria, max_iter)
        loop = self._fused.get(key)
        if loop is None:
            if self._graph_pool is None and self.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
            loop = self._fused[key] = FusedLoop(
                self.cfg, self.levels, self.coarse_op,
                _numerator(self.levels, self.M, self.Minv_diag, criteria),
                max_iter, self._graph_pool)
        return loop

    def _loop_events(self):
        """The (start, end) CUDA events around the solve's loop, made once
        per context; None off the card."""
        if self.device.type != "cuda":
            return None
        if self._events is None:
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
        return self._events

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ---- solving -----------------------------------------------------------

    def solve(
        self,
        rhs: np.ndarray,
        x0: Optional[np.ndarray] = None,
        *,
        tol: float = 1e-4,
        criteria: int = 2,
        max_iter: int = 100,
        mode: str = "traced",
    ):
        """Iterate cycles until the residual criterion drops below tol.

        ``mode="traced"`` runs a host loop that dispatches one cycle ahead
        of the residual it waits for (at most one speculative cycle is
        discarded) and records real (elapsed_ms, residual) pairs like the
        reference (multigrid_solver.cpp:1408-1443).  ``mode="fused"`` is
        the JAX package's device loop (:class:`FusedLoop`): on the card
        the cycle, captured once per (columns, criteria, max_iter), runs
        under a conditional WHILE node, one graph launch and one host
        wait per warm solve; its timestamps are synthetic (the elapsed
        time spread uniformly, ``timing["trace_timestamps_synthetic"]``).
        Both return the first iterate meeting tol; ``dispatched`` counts
        the cycles the card ran, a discarded lookahead cycle included.

        Before iterating, the constant near-null component is removed
        exactly: ``x = y + alpha*1`` with ``alpha = sum(b) / sum(A @ 1)``
        (f64), so the transformed RHS is mean-free and f32 cancellation
        stays far below tolerance even for Poisson (eta*M + S).  The gate
        and ``sum(A @ 1)`` are the LHS's (:func:`deflation_denominator`,
        set by ``_analyze_lhs``); alpha, the deflation and the
        un-deflation run on the device in f64, so the host makes no pass
        over the rhs or the answer beyond the two copies.
        ``timing["deflated_columns"]`` counts the columns deflated (d, or
        0 where the gate refused).  Residual denominators use the original
        RHS.
        """
        if mode not in ("traced", "fused"):
            raise ValueError(f"unknown solve mode {mode!r}")
        with span(self.timing, "solve_upload", host_only=False):
            with span(self.timing, "solve_deflation", host_only=True):
                rhs = np.ascontiguousarray(rhs, dtype=np.float64)
                squeeze = rhs.ndim == 1
                d = 1 if squeeze else rhs.shape[1]
                denom = self.deflation_denom    # the LHS's gate, or None
            # one f64 upload of the rhs as given; the deflation on the device
            alpha, rhs_c, b = device_deflation(
                torch.from_numpy(rhs).to(self.device), self._row_sums_dev,
                denom, self.dtype)
            den = residual_denominator(self.M, self.Minv_diag, rhs_c, criteria)
            if x0 is not None:
                # A warm start of a near-singular system sits at O(alpha), and
                # y0 = x0 - alpha is a cancellation done in f64 before rounding.
                x0 = torch.from_numpy(
                    np.ascontiguousarray(x0, dtype=np.float64)).to(self.device)
                y0 = (x0[:, None] if x0.ndim == 1 else x0) - alpha
                x = (y0[:, 0] if squeeze else y0).to(self.dtype)
            else:
                x = torch.zeros_like(b)
            self.timing["deflated_columns"] = float(0 if denom is None else d)
            cfg = self.cfg
            convergence: list = []
            self._sync()
        for key in _FUSED_TIMING:
            self.timing.pop(key, None)
        events = self._loop_events()
        with span(self.timing, "cycles", host_only=False) as loop_span:
            t0 = loop_span.t0
            if events is not None:
                events[0].record(torch.cuda.current_stream(self.device))
            if cfg.num_levels == 0:
                # Mesh at/below lower_bound: the coarsest operator IS the full
                # system, so one refined inverse apply solves it
                # (multigrid_solver.cpp:1401).
                x = _coarse_solve(self.coarse_op, b, cfg.coarse_null_project)
                res = self.residual(rhs, (x.double() + alpha).cpu().numpy(),
                                    criteria=criteria)
                iters = 1
                dispatched = 1
                convergence = [((time.perf_counter() - t0) * 1000, res)]
            elif mode == "fused":
                loop = self._fused_loop(None if squeeze else d, criteria,
                                        max_iter)
                x, iters, res, trace, reads, launches = loop.run(b, x, den, tol)
                dispatched = iters
                elapsed = (time.perf_counter() - t0) * 1000
                convergence = [(elapsed * (i + 1) / max(iters, 1), r)
                               for i, r in enumerate(trace)]
                self.timing.update(trace_timestamps_synthetic=1.0,
                                   **loop_timing(loop, reads, launches))
            else:
                A = self.levels[0].A
                iters = 0
                res = float("inf")
                inflight: deque = deque()
                x_next = x
                dispatched = 0
                stop = False
                while True:
                    while (not stop and dispatched < max_iter
                           and len(inflight) < 2):
                        x_next = cycle_step(
                            cfg, self.levels, self.coarse_op, b, x_next
                        )
                        num = residual_numerator(
                            A, self.M, self.Minv_diag, b, x_next, criteria
                        )
                        inflight.append((x_next, torch.max(num / den)))
                        dispatched += 1
                    if not inflight:
                        break
                    xq, rq = inflight.popleft()
                    res = float(rq)
                    iters += 1
                    convergence.append(((time.perf_counter() - t0) * 1000, res))
                    x = xq
                    if res <= tol:
                        stop = True
                        inflight.clear()
            if events is not None:
                events[1].record(torch.cuda.current_stream(self.device))
        self.timing["iterations"] = float(iters)
        # cycles the device ran, the traced loop's discarded lookahead included
        self.dispatched = dispatched
        self.timing["residue"] = res
        with span(self.timing, "solve_copy_back", host_only=False):
            # the un-deflation x = y + alpha: one f64 add on the device, then
            # one copy to the host
            out = (x.double() + alpha).cpu().numpy()
        if events is not None:
            # the copy back waited for the stream, so both events are done
            self.timing["loop_device"] = events[0].elapsed_time(events[1])
        self.timing["solver_total"] = sum(self.timing[k] for k in (
            "solve_upload", "cycles", "solve_copy_back") + (
            ("plan_build", "reduction") if self._fresh else ()))
        self._fresh = False
        return out, iters, res, convergence

    def residual(self, rhs, x, criteria: int = 2) -> float:
        """Exact residual of the original system, evaluated on the host in
        f64 (solutions of near-singular systems are too large for f32
        cancellation)."""
        rhs = np.asarray(rhs, dtype=np.float64)
        x = np.asarray(x, dtype=np.float64)
        rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
        x2 = x[:, None] if x.ndim == 1 else x
        r = self.lhs_csr @ x2 - rhs2
        M = self.mass_csr
        if criteria == 0:
            vals = np.linalg.norm(r, axis=0) / np.maximum(
                np.linalg.norm(rhs2, axis=0), 1e-30
            )
        elif criteria == 1:
            minv = 1.0 / np.maximum(M.diagonal(), 1e-300)
            vals = np.sqrt(
                (r * (minv[:, None] * r)).sum(axis=0)
                / np.maximum((rhs2 * (minv[:, None] * rhs2)).sum(axis=0), 1e-300)
            )
        elif criteria == 2:
            vals = np.sqrt(
                (r * (M @ r)).sum(axis=0)
                / np.maximum((rhs2 * (M @ rhs2)).sum(axis=0), 1e-300)
            )
        elif criteria == 3:
            vals = [np.linalg.norm(r)]
        else:
            raise ValueError(f"unknown stopping criteria {criteria}")
        return float(np.max(vals))
