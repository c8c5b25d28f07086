"""Public MultigridSolver facade.

Counterpart of ``gravo_mg_tpu/core.py``: same constructor signature and
defaults (plus ``device`` and ``diag_min_groups``), eager hierarchy build,
``solve``/``direct_solve``/``residual``, hierarchy introspection getters,
prolongation injection, and timing / convergence writers.  The solve runs
on ``device``; asking for ``"cuda"`` without a GPU raises, and the solver
never falls back to the CPU on its own.
"""

from __future__ import annotations

import hashlib
from typing import List

import numpy as np
import scipy.sparse as sp
import torch

from .enums import Hierarchy, Sampling, Smoother, Weighting
from .hierarchy.builder import Hierarchy as HierarchyData
from .hierarchy.builder import HierarchyLevel, build_hierarchy
from .solver.direct import direct_solve
from .solver.multigrid import MultigridSolveContext, SolverConfig
from .sparse import make_prolongation
from .utils.io import write_convergence_csv, write_timing_csv


def _pattern_key(lhs) -> str:
    lhs = lhs.tocsr()
    h = hashlib.sha1()
    h.update(np.ascontiguousarray(lhs.indptr).tobytes())
    h.update(np.ascontiguousarray(lhs.indices).tobytes())
    return h.hexdigest()


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to gravo_mg_tpu_torch yet (ROADMAP Queue 1: "
        f"{item}); use gravo_mg_tpu for it"
    )


def _resolve_device(device) -> torch.device:
    """The torch device to solve on; CUDA must really be there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path explicitly"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class MultigridSolver:
    """Gravo-MG-capability geometric multigrid solver on PyTorch/CUDA."""

    def __init__(
        self, pos, neigh, mass,
        ratio=8.0, lower_bound=1000, cycle_type=0, tolerance=1e-4,
        stopping_criteria=2, pre_iters=4, post_iters=4, max_iter=100,
        check_voronoi=True, nested=False,
        sampling_strategy=Sampling.FASTDISK, weighting=Weighting.BARYCENTRIC,
        sig06=False, normals=None, verbose=False, debug=False,
        ablation=False, ablation_num_points=3, ablation_random=False,
        smoother=Smoother.CHEBYSHEV, dtype=torch.float32, seed=0,
        device="cuda", diag_min_groups=4096,
    ):
        """Build the solver and (eagerly, like the reference ctor
        core.cpp:20-58) the multigrid hierarchy.

        Args mirror the reference (`core.py:8-57`) and the JAX package;
        ``device`` selects where the solve runs and ``diag_min_groups``
        the row-group count from which a level is planned as DiagEll.
        """
        if sig06:
            _not_ported("sig06 hierarchies", "variants.py/sig21.py hierarchies")
        if ablation:
            _not_ported("ablation hierarchies", "variants.py/sig21.py hierarchies")
        self.device = _resolve_device(device)
        self.pos = np.asarray(pos, dtype=np.float64)
        self.neigh = np.asarray(neigh, dtype=np.int32)
        if not sp.issparse(mass):
            mass = sp.csr_matrix(mass)
        self.mass = mass.tocsr()
        self.normals = (
            np.asarray(normals, dtype=np.float64)
            if normals is not None else None
        )
        self.ratio = float(ratio)
        self.lower_bound = int(lower_bound)
        self.cycle_type = int(cycle_type)
        self.tolerance = float(tolerance)
        self.stopping_criteria = int(stopping_criteria)
        self.pre_iters = int(pre_iters)
        self.post_iters = int(post_iters)
        self.max_iter = int(max_iter)
        self.check_voronoi = bool(check_voronoi)
        self.nested = bool(nested)
        self.sampling_strategy = Sampling(sampling_strategy)
        self.weighting = Weighting(weighting)
        self.verbose = bool(verbose)
        self.debug = bool(debug)
        self.smoother = Smoother(smoother)
        self.dtype = dtype
        self.seed = int(seed)
        self.diag_min_groups = int(diag_min_groups)

        self.hierarchy = build_hierarchy(
            self.pos, self.neigh,
            ratio=self.ratio, lower_bound=self.lower_bound,
            sampling_strategy=self.sampling_strategy,
            weighting=self.weighting,
            check_voronoi=self.check_voronoi, nested=self.nested,
            normals=self.normals,
            seed=self.seed, verbose=self.verbose, debug=self.debug,
        )
        self._hierarchy_ours = self.hierarchy
        self._contexts: dict = {}
        self._active_hierarchy = Hierarchy.OURS
        self.convergence: List[tuple] = []
        self.solver_timing: dict = {}

    # ---- hierarchy management ---------------------------------------------

    def construct_sig21_hierarchy(self, faces, dec_type=1):
        """Decimation-based comparison hierarchy (not ported yet)."""
        _not_ported("construct_sig21_hierarchy", "variants.py/sig21.py hierarchies")

    def toggle_hierarchy(self, hierarchy_type):
        """Switch between hierarchies (reference core.py:71-78); only OURS
        exists in the port so far."""
        hierarchy_type = Hierarchy(hierarchy_type)
        if hierarchy_type != Hierarchy.OURS:
            _not_ported("SIG21 hierarchies", "variants.py/sig21.py hierarchies")
        self.hierarchy = self._hierarchy_ours
        self._active_hierarchy = hierarchy_type
        self._contexts.clear()

    def set_prolongation_matrices(self, U_list):
        """Inject external prolongation matrices (scipy sparse), replacing
        the hierarchy's transfer operators (reference core.cpp:86-88)."""
        import dataclasses as _dc

        levels = []
        dof = [U_list[0].shape[0]]
        for k, U in enumerate(U_list):
            U = U.tocsr()
            deg = np.diff(U.indptr)
            w = max(int(deg.max()), 1)
            cols = np.zeros((U.shape[0], w), dtype=np.int32)
            wts = np.zeros((U.shape[0], w), dtype=np.float64)
            slot = np.arange(U.indices.shape[0]) - np.repeat(U.indptr[:-1], deg)
            rows = np.repeat(np.arange(U.shape[0]), deg)
            cols[rows, slot] = U.indices
            wts[rows, slot] = U.data
            prol = make_prolongation(cols, wts, U.shape[1], dtype=self.dtype)
            src = self.hierarchy.levels[k] if k < len(self.hierarchy.levels) else None
            levels.append(
                _dc.replace(src, U=prol) if src is not None else
                HierarchyLevel(
                    U=prol, samples=np.zeros(0, np.int32),
                    labels=np.zeros(0, np.int32),
                    coarse_points=np.zeros((0, 3)),
                    coarse_neigh=np.zeros((0, 1), np.int32),
                    stats=np.zeros(3, np.int64),
                )
            )
            dof.append(U.shape[1])
        self.hierarchy = HierarchyData(
            dof, levels, self.pos, self.neigh, dict(self.hierarchy.timing)
        )
        self._contexts.clear()

    # ---- solving -----------------------------------------------------------

    # LHS-pattern contexts kept alive per solver: the reference harness
    # alternates between two systems (comparisons.py:150), so an LRU > 1
    # keeps both contexts' layouts instead of replanning on every swap.
    _CONTEXT_LRU = 4

    def _context(self, lhs) -> MultigridSolveContext:
        key = (_pattern_key(lhs), id(self.hierarchy))
        ctx = self._contexts.pop(key, None)  # re-insert to refresh LRU order
        cfg = SolverConfig(
            cycle_type=self.cycle_type,
            pre_iters=self.pre_iters,
            post_iters=self.post_iters,
            smoother=int(self.smoother),
        )
        if ctx is None:
            ctx = MultigridSolveContext(
                self.hierarchy, lhs, self.mass, cfg, dtype=self.dtype,
                device=self.device, diag_min_groups=self.diag_min_groups,
            )
            while len(self._contexts) >= self._CONTEXT_LRU:
                self._contexts.pop(next(iter(self._contexts)))
        else:
            # Same pattern: value-only update unless the values match too.
            lhs2 = lhs.tocsr()
            if lhs2.data.shape != ctx.lhs_csr.data.shape or not np.array_equal(
                lhs2.data, ctx.lhs_csr.data
            ):
                ctx.update_lhs(lhs2)
        self._contexts[key] = ctx
        return ctx

    def solve(self, lhs, rhs, x0=None, mode: str = "traced"):
        """Multigrid-solve ``lhs @ x = rhs`` to the configured tolerance.

        Parity: reference ``solve`` (core.py:80-90 -> solverType 2,
        multigrid_solver.cpp:1367-1451).  Returns x as a numpy array.
        """
        if not sp.issparse(lhs):
            lhs = sp.csr_matrix(lhs)
        rhs = np.asarray(rhs)
        squeeze = rhs.ndim == 1
        ctx = self._context(lhs)
        x, iters, res, conv = ctx.solve(
            rhs, x0,
            tol=self.tolerance, criteria=self.stopping_criteria,
            max_iter=self.max_iter, mode=mode,
        )
        self.convergence = conv
        self.solver_timing = dict(ctx.timing)
        if self.verbose:
            print(f"multigrid: {iters} cycles, residual {res:.3e}")
        return x[:, None] if (not squeeze and x.ndim == 1) else x

    def direct_solve(self, lhs, rhs, pardiso=False):
        """Host sparse direct solve (reference solverType 0/1).

        ``pardiso`` is accepted for API parity; both use SuperLU here.
        """
        if not sp.issparse(lhs):
            lhs = sp.csr_matrix(lhs)
        return direct_solve(lhs, np.asarray(rhs), timing=self.solver_timing)

    def cg_solve(self, lhs, rhs, max_iter: int = 10000):
        """Device conjugate-gradient solve (not ported yet)."""
        _not_ported("cg_solve", "direct.cg_solve")

    def residual(self, lhs, rhs, solution, type=2):
        """Residual in the given norm (reference core.cpp residual)."""
        ctx = self._context(lhs if sp.issparse(lhs) else sp.csr_matrix(lhs))
        return ctx.residual(rhs, solution, criteria=int(type))

    # ---- introspection (reference core.cpp:94-116) -------------------------

    @property
    def prolongation_matrices(self):
        return [lvl.U.to_scipy() for lvl in self.hierarchy.levels]

    @property
    def sampling_indices(self):
        return [lvl.samples for lvl in self.hierarchy.levels]

    @property
    def nearest_source(self):
        return [lvl.labels for lvl in self.hierarchy.levels]

    @property
    def cluster_distances(self):
        """Per-level graph-Voronoi distances to each vertex's cluster seed
        (retained only under ``debug=True``; empty arrays otherwise)."""
        return [
            lvl.cluster_dist if lvl.cluster_dist is not None
            else np.zeros(0)
            for lvl in self.hierarchy.levels
        ]

    @property
    def level_points(self):
        return [lvl.coarse_points for lvl in self.hierarchy.levels]

    @property
    def level_edges(self):
        out = []
        for lvl in self.hierarchy.levels:
            cn = lvl.coarse_neigh
            ii = np.repeat(np.arange(cn.shape[0]), cn.shape[1])
            jj = cn.reshape(-1)
            m = jj >= 0
            out.append(np.stack([ii[m], jj[m]], axis=1))
        return out

    @property
    def all_triangles(self):
        """Candidate triangles per level (c, a, b), derived from the coarse
        graph like the reference's debug dump
        (multigrid_solver.cpp:247-281)."""
        out = []
        for lvl in self.hierarchy.levels:
            cn = lvl.coarse_neigh
            tris = []
            nbr_sets = [set(r[r >= 0].tolist()) for r in cn]
            for c in range(cn.shape[0]):
                row = [x for x in cn[c] if x >= 0 and x > c]
                for ai in range(len(row)):
                    for bi in range(ai + 1, len(row)):
                        a, b = row[ai], row[bi]
                        if not self.check_voronoi or b in nbr_sets[a]:
                            tris.append((c, a, b))
            out.append(np.asarray(tris, dtype=np.int64).reshape(-1, 3))
        return out

    @property
    def notrimap(self):
        """Per-level fallback counters [triangle, edge, closest-3]."""
        return [lvl.stats for lvl in self.hierarchy.levels]

    @property
    def coarse_normals(self):
        """Per-level coarse normals: propagated input normals when the
        ctor received ``normals``, else normalized coarse positions."""
        return [
            lvl.coarse_nrm if lvl.coarse_nrm is not None else
            lvl.coarse_points / np.maximum(
                np.linalg.norm(lvl.coarse_points, axis=1, keepdims=True), 1e-30
            )
            for lvl in self.hierarchy.levels
        ]

    @property
    def hierarchy_timing(self):
        return dict(self.hierarchy.timing)

    # ---- reporting (reference utility.cpp:106-149) -------------------------

    def write_hierarchy_timing(self, experiment, file, write_headers=False):
        write_timing_csv(file, experiment, self.hierarchy.timing, write_headers)

    def write_solver_timing(self, experiment, file, write_headers=False):
        write_timing_csv(file, experiment, self.solver_timing, write_headers)

    def write_convergence(self, file):
        write_convergence_csv(file, self.convergence)
