"""Multigrid solve path: Galerkin reduction, cycles, outer iteration.

Counterpart of ``gravo_mg_tpu/solver/multigrid.py`` (the reference's
``MultigridSolver::solve``, gravomg/src/multigrid_solver.cpp:1279-1485):

* setup is host work in f64: the scipy Galerkin chain
  ``Abar[k+1] = U_k^T Abar[k] U_k``, per-level slot layouts, diagonals,
  spectral bounds and the regularized coarse inverse; the device receives
  only the finished layout tensors;
* V/F/W cycles (reference ``:1059-1192``) recurse over the levels in
  eager torch: degree-4 Chebyshev smoothing around the SpMV kernels, a
  coarse inverse apply with one refinement step;
* the iterate-to-tolerance loop runs on the host, one cycle ahead of the
  residual it waits for, and returns the first iterate that meets tol.

Compute runs in the context's dtype (f32 by default); the exact
constant-mode deflation runs in f64 on the device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..enums import CycleType, Smoother
from ..hierarchy.builder import Hierarchy
from ..sparse import (
    DiagEll,
    EllMatrix,
    ShuffleEll,
    ShuffleTransfer,
    diag_plan_arrays,
    numpy_dtype,
    shuffle_from_scipy,
    shuffle_plan_arrays,
    spmv,
)
from .residual import residual_denominator, residual_numerator
from .smoothers import chebyshev, jacobi


@dataclasses.dataclass
class LevelOps:
    """Per-level operator bundle used by the cycle."""

    A: object                # DiagEll | ShuffleEll | EllMatrix
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
    _coarse_solve would lose its accuracy."""
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


def _cycle(cfg: SolverConfig, levels, coarse, b, x, k: int, kind: int):
    """Recursive cycle (kind: 0=V, 1=F, 2=W)."""
    ops = levels[k]
    x = _smooth(cfg, ops, b, x, cfg.pre_iters)
    r = b - spmv(ops.A, x)
    rc = ops.U.restrict(r)
    if k == cfg.num_levels - 1:
        e = _coarse_solve(coarse, rc, cfg.coarse_null_project)
    else:
        e = _cycle(cfg, levels, coarse, rc, torch.zeros_like(rc), k + 1, kind)
    x = x + ops.U.prolong(e)
    x = _smooth(cfg, ops, b, x, cfg.post_iters)
    if kind != int(CycleType.V):
        # F- and W-cycles run a second correction pass
        # (multigrid_solver.cpp:1091-1192); F recurses into V, W into W.
        r = b - spmv(ops.A, x)
        rc = ops.U.restrict(r)
        if k == cfg.num_levels - 1:
            e = _coarse_solve(coarse, rc, cfg.coarse_null_project)
        else:
            kind2 = int(CycleType.V) if kind == int(CycleType.F) else kind
            e = _cycle(
                cfg, levels, coarse, rc, torch.zeros_like(rc), k + 1, kind2
            )
        x = x + ops.U.prolong(e)
        x = _smooth(cfg, ops, b, x, cfg.post_iters)
    return x


def cycle_step(cfg: SolverConfig, levels, coarse, b, x):
    """One cycle of the configured type from the finest level."""
    return _cycle(cfg, levels, coarse, b, x, 0, cfg.cycle_type)


def deflation_alpha(row_sums: np.ndarray, rhs2: np.ndarray) -> np.ndarray:
    """Exact rank-1 constant-mode deflation coefficients (f64, (d,)).

    Deflate iff the row-sum vector is sign-coherent:
    ``|sum(row_sums)| > 0.1 * sum(|row_sums|)``.  A genuine near-null
    regularization (``eta * M @ 1``) passes at any mesh scale, while pure
    assembly roundoff (random signs) is rejected.
    """
    denom = float(row_sums.sum())
    abs_sum = float(np.abs(row_sums).sum())
    if abs_sum > 0.0 and abs(denom) > 0.1 * abs_sum:
        return np.asarray(rhs2.sum(axis=0) / denom, dtype=np.float64)
    return np.zeros(rhs2.shape[1])


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


def _ell_pattern(A_csr):
    """Transposed-ELL pattern (idx, structural mask) of a csr matrix."""
    degree = np.diff(A_csr.indptr)
    k = max(int(degree.max()) if degree.size else 1, 1)
    n = A_csr.shape[0]
    idx = np.zeros((k, n), dtype=np.int32)
    slot = np.arange(A_csr.indices.shape[0]) - np.repeat(A_csr.indptr[:-1], degree)
    row_ids = np.repeat(np.arange(n), degree)
    idx[slot, row_ids] = A_csr.indices
    mask = np.arange(k)[:, None] < degree[None, :]
    return idx, mask


def _ell_values(A_csr, k: int) -> np.ndarray:
    """(K, N) transposed-ELL values of a csr matrix (host, f64)."""
    degree = np.diff(A_csr.indptr)
    n = A_csr.shape[0]
    vals = np.zeros((k, n), dtype=np.float64)
    slot = np.arange(A_csr.indices.shape[0]) - np.repeat(A_csr.indptr[:-1], degree)
    row_ids = np.repeat(np.arange(n), degree)
    vals[slot, row_ids] = A_csr.data
    return vals


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


def coarse_factor_host(A_coarse_csr, null_fix: bool) -> np.ndarray:
    """Dense f64 Cholesky of the coarsest operator (host LAPACK).

    ``null_fix`` adds sigma * (1 1^T)/n, which moves only the near-null
    constant eigenvalue of near-singular systems (the outer solve deflates
    that mode exactly); a tiny relative diagonal shift plays the role of
    the reference's LDLT robustness (min_quad_with_fixed_mg.cpp:31-36).
    """
    Ad = np.asarray(A_coarse_csr.todense(), dtype=np.float64)
    nc = Ad.shape[0]
    diag_scale = float(np.mean(np.abs(np.diag(Ad))))
    Ad[np.diag_indices(nc)] += 1e-12 * diag_scale
    if null_fix:
        Ad += diag_scale / nc
    return np.linalg.cholesky(Ad)


def coarse_inverse_host(A_coarse_csr, null_fix: bool):
    """(Ainv, Ad) f64 numpy: the inverse of the regularized coarse operator
    (from its Cholesky factor) and the regularized dense operator itself,
    for the refinement step in _coarse_solve."""
    import scipy.linalg

    cho = coarse_factor_host(A_coarse_csr, null_fix)
    nc = cho.shape[0]
    Ainv = scipy.linalg.cho_solve((cho, True), np.eye(nc))
    Ad = np.asarray(A_coarse_csr.todense(), dtype=np.float64)
    diag_scale = float(np.mean(np.abs(np.diag(Ad))))
    Ad[np.diag_indices(nc)] += 1e-12 * diag_scale
    if null_fix:
        Ad += diag_scale / nc
    return Ainv, Ad


class MultigridSolveContext:
    """Everything reusable across solves for one (hierarchy, LHS pattern):
    chain patterns, slot layouts, device level operators, coarse inverse.

    ``diag_min_groups``: levels with at least this many 128-row groups are
    planned as DiagEll (the reference reads it from the environment).
    """

    def __init__(
        self,
        hierarchy: Hierarchy,
        lhs_csr,
        mass_csr,
        cfg: SolverConfig,
        dtype=torch.float32,
        device="cpu",
        diag_min_groups: int = 4096,
    ):
        self.hierarchy = hierarchy
        self.cfg = dataclasses.replace(cfg, num_levels=hierarchy.num_levels)
        self.dtype = dtype
        self.device = torch.device(device)
        self.diag_min_groups = int(diag_min_groups)
        self.timing: dict = {}

        t0 = time.perf_counter()
        self.lhs_csr = lhs_csr.tocsr()
        self._analyze_lhs()
        self.timing["setup_analyze"] = (time.perf_counter() - t0) * 1000
        t0 = time.perf_counter()
        self.mass_csr = mass_csr.tocsr()
        self.M = shuffle_from_scipy(mass_csr, dtype=dtype).to(self.device)
        minv = 1.0 / np.maximum(np.asarray(mass_csr.diagonal()), 1e-30)
        self.Minv_diag = torch.from_numpy(minv).to(self.device, dtype)
        self.timing["setup_mass"] = (time.perf_counter() - t0) * 1000

        # --- pattern discovery: f64 scipy Galerkin chain ------------------
        t0 = time.perf_counter()
        self.U_csr = [lvl.U.to_scipy() for lvl in hierarchy.levels]
        self.timing["setup_u_host"] = (time.perf_counter() - t0) * 1000
        t1 = time.perf_counter()
        chain = galerkin_chain_scipy(self.lhs_csr, self.U_csr)
        self.timing["setup_chain"] = (time.perf_counter() - t1) * 1000
        t1 = time.perf_counter()
        self._patterns = [_ell_pattern(A) for A in chain[:-1]]
        self._ell_k = [p[0].shape[0] for p in self._patterns]
        self.timing["setup_patterns"] = (time.perf_counter() - t1) * 1000
        self.timing["plan_build"] = (time.perf_counter() - t0) * 1000

        # --- slot layouts (pattern-only, reused across LHS values) --------
        # Per-level work bottoms out in native sorts that release the GIL.
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            self._shuf_np = list(pool.map(
                lambda p: self._plan_level(*p), self._patterns
            ))
        self.timing["setup_shuffle_layout"] = (time.perf_counter() - t0) * 1000
        t1 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as pool:
            self.transfers = tuple(
                pool.map(self._build_transfer, enumerate(self.U_csr))
            )
        self.timing["setup_transfers"] = (time.perf_counter() - t1) * 1000
        self.timing["shuffle_plan"] = (time.perf_counter() - t0) * 1000

        # Map each layout's src (flattened (K, N) ELL position, slot * N +
        # row) straight to csr data positions (indptr[row] + slot), so the
        # per-solve value fill is one gather from A.data.  The padding
        # sentinel K*N maps to an appended zero at nnz.
        t0 = time.perf_counter()
        self._csr_src = []
        for k2, plan in enumerate(self._shuf_np):
            if plan[0] == "ell":
                self._csr_src.append(None)
                continue
            src = plan[4] if plan[0] == "diag" else plan[3]
            indptr = chain[k2].indptr
            n2 = chain[k2].shape[0]
            if self._ell_k[k2] * n2 < 2**31 and chain[k2].nnz < 2**31:
                flat = src.ravel().astype(np.int32, copy=False)
                pad = flat == np.int32(self._ell_k[k2] * n2)
                slot, row = np.divmod(flat, np.int32(n2))
                csr_pos = indptr.astype(np.int32)[row] + slot
                csr_pos[pad] = np.int32(chain[k2].nnz)
            else:
                flat = src.astype(np.int64).ravel()
                pad = flat == (self._ell_k[k2] * n2)
                slot, row = np.divmod(flat, np.int64(n2))
                csr_pos = indptr[row] + slot
                csr_pos[pad] = chain[k2].nnz
            self._csr_src.append(csr_pos.reshape(src.shape))
        self.timing["setup_csr_src"] = (time.perf_counter() - t0) * 1000
        self._dev_r: dict = {}

        # --- values: fill layouts, spectral bounds, coarse inverse, upload
        self._reduce_and_upload(chain)

    def _plan_level(self, idx, mask):
        """Per-level sparse-layout choice (tagged plan tuple).

        Levels with >= ``diag_min_groups`` row groups get the DiagEll
        layout while its slot padding stays within the reference's traffic
        bound against ShuffleEll (9 vs 17 bytes per slot lane, counted for
        the TPU kernels, where ShuffleEll also round-trips z through HBM);
        everything else uses ShuffleEll.  Layouts padding beyond
        max(8 nnz, 2^24) fall back to transposed ELL.
        """
        n = idx.shape[1]
        s_groups = -(-n // 128)
        plan = None
        if s_groups >= self.diag_min_groups:
            dplan = diag_plan_arrays(idx, mask, n)
            kp_d = dplan[2].shape[0]
            # Cheap accept first: kp_shuffle >= K, so passing the bound
            # against K proves it against the shuffle layout unbuilt.
            if 9 * kp_d <= 2 * 17 * idx.shape[0]:
                plan = ("diag",) + dplan
            else:
                splan = shuffle_plan_arrays(idx, mask, n)
                if 9 * kp_d <= 2 * 17 * splan[0].shape[0]:
                    plan = ("diag",) + dplan
                else:
                    plan = ("shuf",) + splan
        if plan is None:
            plan = ("shuf",) + shuffle_plan_arrays(idx, mask, n)
        nnz = int(np.asarray(mask).sum())
        r_arr = plan[3] if plan[0] == "diag" else plan[2]
        padded = r_arr.shape[0] * r_arr.shape[1] * 128
        if padded > max(8 * nnz, 1 << 24):
            return ("ell",)
        return plan

    def _level_rv(self, k, r_np, A):
        """Device (KP, *, 128) lane/value tensors for level k's operator:
        the padded values are gathered on the host in compute dtype; the
        lane array depends only on the pattern and is uploaded once."""
        table = np.append(A.data, 0.0).astype(numpy_dtype(self.dtype), copy=False)
        v = torch.from_numpy(table[self._csr_src[k]]).to(self.device)
        if k not in self._dev_r:
            self._dev_r[k] = torch.from_numpy(r_np).to(self.device)
        return self._dev_r[k], v

    def _build_transfer(self, k_and_Ucsr):
        """ShuffleTransfer for level k's U/U^T, or the hierarchy's
        Prolongation (gather + index_add) where either shuffle layout
        would pad beyond 24x nnz.  The finest U^T legitimately pads ~17x
        at 1M rows, hence the loose cap."""
        k, Ucsr = k_and_Ucsr
        cap = max(24 * Ucsr.nnz, 1 << 24)
        U_sh = shuffle_from_scipy(Ucsr, dtype=self.dtype, size_cap=cap)
        UT_sh = (
            shuffle_from_scipy(Ucsr.T.tocsr(), dtype=self.dtype, size_cap=cap)
            if U_sh is not None else None
        )
        if U_sh is None or UT_sh is None:
            return self.hierarchy.levels[k].U.to(self.device, self.dtype)
        return ShuffleTransfer(U_sh, UT_sh).to(self.device)

    def _reduce_and_upload(self, chain):
        """Value-dependent half of setup: per-level layout values,
        diagonals, lambda_max, coarse inverse — host-computed, uploaded."""
        t0 = time.perf_counter()
        levels = []
        t_values = t_spec = 0.0
        npdt = numpy_dtype(self.dtype)
        for k in range(self.cfg.num_levels):
            A = chain[k]
            t1 = time.perf_counter()
            diag = A.diagonal()
            diag_inv_np = 1.0 / np.where(np.abs(diag) > 1e-30, diag, 1.0)
            t2 = time.perf_counter()
            lam = lambda_max_host(A, diag_inv_np)
            t3 = time.perf_counter()
            plan = self._shuf_np[k]
            if plan[0] == "ell":
                idx, _mask = self._patterns[k]
                A_dev = EllMatrix(
                    torch.from_numpy(idx.astype(np.int64)),
                    torch.from_numpy(_ell_values(A, self._ell_k[k]).astype(npdt)),
                    A.shape[1],
                ).to(self.device)
            elif plan[0] == "diag":
                _, start, tg, r, _src = plan
                rj, vj = self._level_rv(k, r, A)
                A_dev = DiagEll(
                    torch.from_numpy(start).to(self.device), rj, vj,
                    tg, A.shape[0], A.shape[1],
                )
            else:
                _, q, r, _src = plan
                rj, vj = self._level_rv(k, r, A)
                A_dev = ShuffleEll(
                    torch.from_numpy(q).to(self.device), rj, vj,
                    A.shape[0], A.shape[1],
                )
            diag_inv = torch.from_numpy(diag_inv_np).to(self.device, self.dtype)
            # lam_max rounded to the compute dtype, as the reference stores it
            levels.append(LevelOps(
                A_dev, diag_inv, float(np.asarray(lam, npdt)), self.transfers[k]
            ))
            t_values += (t2 - t1) + (time.perf_counter() - t3)
            t_spec += t3 - t2
        self.levels = tuple(levels)
        t1 = time.perf_counter()
        Ainv, Ad = coarse_inverse_host(chain[-1], self.near_singular)
        self.coarse_op = (
            torch.from_numpy(Ainv).to(self.device, self.dtype),
            torch.from_numpy(Ad).to(self.device, self.dtype),
        )
        self.timing["setup_values"] = t_values * 1000
        self.timing["setup_spectral"] = t_spec * 1000
        self.timing["setup_coarse_factor"] = (time.perf_counter() - t1) * 1000
        self.timing["reduction"] = (time.perf_counter() - t0) * 1000

    def _analyze_lhs(self):
        """f64 row sums (= A @ 1) and near-singularity detection, for the
        exact constant-mode deflation (see solve()) and the coarse
        nullspace fix (see coarse_factor_host)."""
        self.row_sums = np.asarray(
            self.lhs_csr.sum(axis=1), dtype=np.float64
        ).ravel()
        n = self.lhs_csr.shape[0]
        scale = float(np.abs(self.lhs_csr.diagonal()).mean())
        self.near_singular = (
            abs(float(self.row_sums.sum())) < 1e-6 * scale * n
        )
        self.cfg = dataclasses.replace(
            self.cfg, coarse_null_project=self.near_singular
        )
        self._row_sums_dev = torch.from_numpy(self.row_sums).to(self.device)

    def update_lhs(self, lhs_csr):
        """Re-run the value-only reduction for a new LHS with the same
        sparsity pattern: layouts and transfers are reused; the chain,
        value fills and the coarse inverse recompute."""
        t0 = time.perf_counter()
        self.lhs_csr = lhs_csr.tocsr()
        self._analyze_lhs()
        chain = galerkin_chain_scipy(self.lhs_csr, self.U_csr)
        self.timing["plan_build"] = (time.perf_counter() - t0) * 1000
        self._reduce_and_upload(chain)

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

        Both modes run the same host loop, which dispatches one cycle
        ahead of the residual it waits for (at most one speculative cycle
        is discarded) and records real (elapsed_ms, residual) pairs like
        the reference (multigrid_solver.cpp:1408-1443).  The returned
        iterate is the first one meeting tol.

        Before iterating, the constant near-null component is removed
        exactly: ``x = y + alpha*1`` with ``alpha = sum(b) / sum(A @ 1)``
        (f64), so the transformed RHS is mean-free and f32 cancellation
        stays far below tolerance even for Poisson (eta*M + S).  Residual
        denominators use the original RHS.
        """
        if mode not in ("traced", "fused"):
            raise ValueError(f"unknown solve mode {mode!r}")
        t_up = time.perf_counter()
        rhs = np.asarray(rhs, dtype=np.float64)
        squeeze = rhs.ndim == 1
        rhs2 = rhs[:, None] if squeeze else rhs
        alpha = deflation_alpha(self.row_sums, rhs2)  # (d,) f64
        # One compute-dtype upload of the raw rhs; the f64 deflation
        # ``b = rhs - alpha * (A @ 1)`` runs on the device.
        rhs_dev = torch.from_numpy(
            np.ascontiguousarray(rhs2[:, 0] if squeeze else rhs2)
        ).to(self.device, self.dtype)
        alpha_dev = torch.from_numpy(
            np.asarray(alpha[0] if squeeze else alpha[None, :])
        ).to(self.device)
        rs_dev = self._row_sums_dev if squeeze else self._row_sums_dev[:, None]
        b = (rhs_dev.double() - alpha_dev * rs_dev).to(self.dtype)
        den = residual_denominator(self.M, self.Minv_diag, rhs_dev, criteria)
        if x0 is not None:
            # The x0 deflation stays on the host in f64: a warm start of a
            # near-singular system sits at O(alpha), and y0 = x0 - alpha is
            # a cancellation that must happen before rounding.
            x0 = np.asarray(x0, dtype=np.float64)
            y0 = (x0[:, None] if x0.ndim == 1 else x0) - alpha[None, :]
            x = torch.from_numpy(
                np.ascontiguousarray(y0[:, 0] if squeeze else y0)
            ).to(self.device, self.dtype)
        else:
            x = torch.zeros_like(b)
        cfg = self.cfg
        convergence: list = []
        self._sync()
        self.timing["solve_upload"] = (time.perf_counter() - t_up) * 1000
        t0 = time.perf_counter()
        if cfg.num_levels == 0:
            # Mesh at/below lower_bound: the coarsest operator IS the full
            # system, so one refined inverse apply solves it
            # (multigrid_solver.cpp:1401).
            x = _coarse_solve(self.coarse_op, b, cfg.coarse_null_project)
            y2_ = x.double().cpu().numpy().reshape(rhs2.shape) + alpha[None, :]
            res = self.residual(rhs2, y2_, criteria=criteria)
            iters = 1
            convergence = [((time.perf_counter() - t0) * 1000, res)]
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
        elapsed = (time.perf_counter() - t0) * 1000
        self.timing["cycles"] = elapsed
        self.timing["iterations"] = float(iters)
        self.timing["residue"] = res
        self.timing["solver_total"] = elapsed + self.timing.get("reduction", 0)
        y = x.double().cpu().numpy()
        out = (y[:, None] if squeeze else y) + alpha[None, :]
        return (out[:, 0] if squeeze else out), iters, res, convergence

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
