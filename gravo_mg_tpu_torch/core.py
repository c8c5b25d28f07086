"""Public MultigridSolver facade.

Counterpart of ``gravo_mg_tpu/core.py``: same constructor signature and
defaults (plus ``device`` and ``diag_min_groups``), eager hierarchy build
(ours, SIG06 or ablation; SIG21 on request and by ``toggle_hierarchy``),
``solve``/``direct_solve``/``cg_solve``/``residual``, hierarchy introspection getters,
prolongation injection, and timing / convergence writers.  The solve runs
on ``device``; asking for ``"cuda"`` without a GPU raises, and the solver
never falls back to the CPU on its own.
"""

from __future__ import annotations

import ctypes
import os
import weakref
from concurrent.futures import ThreadPoolExecutor, wait
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from .enums import Hierarchy, Sampling, Smoother, Weighting
from .hierarchy.builder import Hierarchy as HierarchyData
from .hierarchy.builder import HierarchyLevel, build_hierarchy
from .hierarchy.variants import build_hierarchy_ablation, build_hierarchy_sig06
from .solver.direct import cg_solve, direct_solve
from .solver.multigrid import MultigridSolveContext, SolverConfig
from .sparse import make_prolongation, resolve_device
from .utils.io import write_convergence_csv, write_timing_csv
from .utils.profiler import span


_memcmp = ctypes.CDLL(None).memcmp
_memcmp.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t)
_memcmp.restype = ctypes.c_int
# One core's memcmp reaches a fraction of the host's memory bandwidth, so a
# compare is cut into up to _COMPARE_PARTS parts of at least _PART bytes,
# run at once by the facade's compare threads (ctypes drops the GIL).
_COMPARE_PARTS = min(8, os.cpu_count() or 1)
# A call that runs ahead (``MultigridSolver.solve``) compares in at most
# four parts, and half the cores, while its own thread uploads, launches
# and waits: on an 8-core host of an H100, eight compare threads slowed
# that thread's upload ~1.9x, four ~1.3x, for as fast a call.
_AHEAD_PARTS = max(1, min(4, (os.cpu_count() or 1) // 2))
_PART = 1 << 20


def _alike(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype


def _same_bytes(a: np.ndarray, own: np.ndarray, pool, parts=None) -> bool:
    """Whether ``a`` holds the bytes of ``own``, a contiguous array of the
    same shape and dtype: ``memcmp`` at memory speed, with no temporary,
    in up to ``parts`` (default ``_COMPARE_PARTS``) parts over ``pool``'s
    threads and the caller's."""
    a = np.ascontiguousarray(a)
    n, pa, po = a.nbytes, a.ctypes.data, own.ctypes.data
    k = max(1, min(parts or _COMPARE_PARTS, n // _PART))
    step = -(-n // k) or 1
    rest = [pool.submit(_memcmp, pa + o, po + o, min(step, n - o))
            for o in range(step, n, step)]
    same = n == 0 or _memcmp(pa, po, min(step, n)) == 0
    # wait for every part: ``a`` may be a copy that the threads still read
    return not any([f.result() for f in rest]) and same


class _OwnedLHS:
    """A context's key in ``MultigridSolver._contexts``: the hierarchy the
    context was built on and the facade's own copies of the ``indptr``,
    ``indices`` and ``data`` it was last set up with.  Compared with them
    byte for byte, a caller's CSR matrix finds its context without a hash,
    and an edit of the caller's arrays in place shows at the next call."""

    __slots__ = ("hierarchy", "shape", "indptr", "indices", "data")

    def __init__(self, hierarchy, lhs):
        self.hierarchy, self.shape = hierarchy, lhs.shape
        self.indptr, self.indices, self.data = (
            np.array(a) for a in (lhs.indptr, lhs.indices, lhs.data))

    def admits(self, hierarchy, lhs) -> bool:
        """The prefilter: the same hierarchy and shape, and index arrays
        of the same lengths and dtypes."""
        return (hierarchy is self.hierarchy and lhs.shape == self.shape
                and _alike(lhs.indptr, self.indptr)
                and _alike(lhs.indices, self.indices))

    def same_pattern(self, lhs, pool, parts=None) -> bool:
        return (_same_bytes(lhs.indptr, self.indptr, pool, parts)
                and _same_bytes(lhs.indices, self.indices, pool, parts))

    def same_values(self, lhs, pool, parts=None) -> bool:
        """Byte equality: ``-0.0`` against ``0.0`` reads as a change,
        which costs a refresh and never reuses a stale system."""
        return (_alike(lhs.data, self.data)
                and _same_bytes(lhs.data, self.data, pool, parts))

    def confirm(self, lhs, pool, timing) -> tuple:
        """``(same pattern, same values)`` in ``_AHEAD_PARTS`` parts, each
        compare timed into ``timing``; the values are compared only under
        the same pattern."""
        with span(timing, "facade_pattern_key", host_only=True):
            pattern = self.same_pattern(lhs, pool, _AHEAD_PARTS)
        if not pattern:
            return False, False
        with span(timing, "facade_value_compare", host_only=True):
            return True, self.same_values(lhs, pool, _AHEAD_PARTS)

    def take_values(self, lhs):
        """Copy the caller's values into the owned buffer (a new one only
        where their dtype changed: a fresh array costs page faults)."""
        if _alike(lhs.data, self.data):
            np.copyto(self.data, lhs.data)
        else:
            self.data = np.array(lhs.data)


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
        device="cuda", diag_min_groups=4096, hierarchy_engine="native",
    ):
        """Build the solver and (eagerly, like the reference ctor
        core.cpp:20-58) the multigrid hierarchy.

        Args mirror the reference (`core.py:8-57`) and the JAX package;
        ``device`` selects where the solve runs, ``diag_min_groups``
        the count of 128-row groups from which a level may be planned as
        SlicedDiag (where that streams fewer bytes per apply than
        SlicedEll), and ``hierarchy_engine`` how the hierarchy (ours,
        SIG06 or ablation) is built: ``"native"`` in the port's C++, or
        ``"device"`` by Luby sampling, Bellman-Ford clustering and batched
        weights in torch on ``device`` (the JAX package's hierarchy
        without its native library, ``GRAVO_MG_NO_NATIVE=1``).
        """
        self.device = resolve_device(device)
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
        engine = dict(engine=hierarchy_engine, device=self.device)

        if sig06:
            self.hierarchy = build_hierarchy_sig06(
                self.pos, self.neigh,
                lower_bound=self.lower_bound, seed=self.seed,
                verbose=self.verbose, **engine,
            )
        elif ablation:
            self.hierarchy = build_hierarchy_ablation(
                self.pos, self.neigh,
                ratio=self.ratio, lower_bound=self.lower_bound,
                num_points=int(ablation_num_points),
                random_points=bool(ablation_random),
                nested=self.nested, seed=self.seed, verbose=self.verbose,
                **engine,
            )
        else:
            self.hierarchy = build_hierarchy(
                self.pos, self.neigh,
                ratio=self.ratio, lower_bound=self.lower_bound,
                sampling_strategy=self.sampling_strategy,
                weighting=self.weighting,
                check_voronoi=self.check_voronoi, nested=self.nested,
                normals=self.normals,
                seed=self.seed, verbose=self.verbose, debug=self.debug,
                **engine,
            )
        self._hierarchy_ours = self.hierarchy
        self._hierarchy_sig21: Optional[HierarchyData] = None
        self._contexts: dict = {}
        # the LHS object of the previous solve, where that call found its
        # context by the pattern with equal values (see ``solve``); weak,
        # so it never keeps the caller's matrix alive
        self._repeat: Optional[weakref.ref] = None
        # threads that compare a call's LHS with the contexts' own copies,
        # started at the first compare that is split: a run-ahead call's
        # compares take one, their parts others
        self._compare_pool = ThreadPoolExecutor(
            max(_COMPARE_PARTS - 1, _AHEAD_PARTS),
            thread_name_prefix="facade-compare")
        self._cg_units: dict = {}     # cg_solve's captured unit (direct.py)
        self._active_hierarchy = Hierarchy.OURS
        self.convergence: List[tuple] = []
        self.solver_timing: dict = {}

    # ---- hierarchy management ---------------------------------------------

    def construct_sig21_hierarchy(self, faces, dec_type=1):
        """Build the decimation-based (SIG21) comparison hierarchy
        (reference ``constructSIG21Hierarchy``,
        multigrid_solver.cpp:1488-1503); ``dec_type`` 0 qslim, 1 midpoint
        (default), 2 vertex removal (SSP_decimate.h:22)."""
        from .hierarchy.sig21 import build_sig21_hierarchy

        self._hierarchy_sig21 = build_sig21_hierarchy(
            self.pos, np.asarray(faces), dec_type=dec_type,
            verbose=self.verbose,
        )
        # Reference parity: the build time lands in the solver's hierarchy
        # timing (multigrid_solver.cpp:1502), so timing CSVs written while
        # OURS is active carry the column too.
        for h in (self._hierarchy_ours, self.hierarchy):
            h.timing["sig21_hierarchy"] = self._hierarchy_sig21.timing[
                "sig21_hierarchy"
            ]

    def toggle_hierarchy(self, hierarchy_type):
        """Switch between hierarchies (reference core.py:71-78)."""
        hierarchy_type = Hierarchy(hierarchy_type)
        if hierarchy_type == Hierarchy.OURS:
            self.hierarchy = self._hierarchy_ours
        elif hierarchy_type in (Hierarchy.SIG21, Hierarchy.SIG21BARY):
            if self._hierarchy_sig21 is None:
                raise AssertionError(
                    "construct_sig21_hierarchy must be called first"
                )
            self.hierarchy = self._hierarchy_sig21
        self._active_hierarchy = hierarchy_type
        self._drop_contexts()

    def _drop_contexts(self):
        """Forget every solve context, with its fused solves' graphs."""
        for ctx in self._contexts.values():
            ctx.release_graphs()
        self._contexts.clear()
        self._repeat = None

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
        self._drop_contexts()

    # ---- solving -----------------------------------------------------------

    # LHS-pattern contexts kept alive per solver: the reference harness
    # alternates between two systems (comparisons.py:150), so an LRU > 1
    # keeps both contexts' layouts instead of replanning on every swap.
    _CONTEXT_LRU = 4

    def _context(self, lhs, timing=None, tried=None) -> MultigridSolveContext:
        """The context of ``lhs``'s pattern, its values refreshed where they
        changed.  The lookup (the prefilter and the byte compares of the
        pattern, newest context first) and the value compare are timed
        into ``timing``, beside ``facade_patterns_compared``: the stored
        patterns this call compared byte for byte.  ``tried`` is a key
        whose pattern this call has compared already and found to differ:
        it is counted, and not compared again.  Where ``lhs`` found its
        context by the pattern with equal values, the next solve with the
        same ``lhs`` object may run ahead (``solve``)."""
        caller = lhs
        with span(timing, "facade_pattern_key", host_only=True):
            lhs = lhs.tocsr()
            key, compared = None, 0
            for cand in reversed(self._contexts):
                if cand.admits(self.hierarchy, lhs):
                    compared += 1
                    if (cand is not tried
                            and cand.same_pattern(lhs, self._compare_pool)):
                        key = cand
                        break
            # re-inserted below, which refreshes the LRU order
            ctx = self._contexts.pop(key) if key is not None else None
        if timing is not None:
            timing["facade_patterns_compared"] = compared
        cfg = SolverConfig(
            cycle_type=self.cycle_type,
            pre_iters=self.pre_iters,
            post_iters=self.post_iters,
            smoother=int(self.smoother),
        )
        hit = False
        if ctx is None:
            ctx = MultigridSolveContext(
                self.hierarchy, lhs, self.mass, cfg, dtype=self.dtype,
                device=self.device, diag_min_groups=self.diag_min_groups,
            )
            key = _OwnedLHS(self.hierarchy, lhs)
            while len(self._contexts) >= self._CONTEXT_LRU:
                self._contexts.pop(next(iter(self._contexts))).release_graphs()
        else:
            # Same pattern: value-only update unless the values match too.
            with span(timing, "facade_value_compare", host_only=True):
                hit = key.same_values(lhs, self._compare_pool)
            if not hit:
                self._refresh(ctx, key, lhs)
        self._contexts[key] = ctx
        self._repeat = weakref.ref(caller) if hit else None
        return ctx

    def _refresh(self, ctx, key, lhs):
        """Take ``lhs``'s new values, same pattern, into ``ctx`` and ``key``."""
        ctx.update_lhs(lhs)
        key.take_values(lhs)
        self._repeat = None

    def _solve_ahead(self, key, ctx, lhs, rhs, x0, solve_kw, timing):
        """Solve on ``key``'s context ``ctx`` while the compare pool
        confirms that ``lhs`` (CSR) still has its pattern and values.
        Returns the answer, solved again after a value refresh where the
        values differed, or None where the pattern differed."""
        ahead: dict = {}
        compares = self._compare_pool.submit(
            key.confirm, lhs, self._compare_pool, ahead)
        try:
            out = ctx.solve(rhs, x0, **solve_kw)
        finally:
            # the pool reads the caller's arrays and the owned copies: none
            # is written, and nothing returns, before it is done
            with span(timing, "facade_compare_wait", host_only=True):
                wait([compares])
        same_pattern, same_values = compares.result()
        timing.update(ahead, facade_ran_ahead=1.0,
                      facade_discarded=float(not same_values))
        if not same_pattern:
            return None
        timing["facade_patterns_compared"] = 1
        if not same_values:
            self._refresh(ctx, key, lhs)
            out = ctx.solve(rhs, x0, **solve_kw)
        return out

    def solve(self, lhs, rhs, x0=None, mode: str = "traced"):
        """Multigrid-solve ``lhs @ x = rhs`` to the configured tolerance.

        Parity: reference ``solve`` (core.py:80-90 -> solverType 2,
        multigrid_solver.cpp:1367-1451).  Returns x as a numpy array.
        ``mode="traced"`` steps the cycles from the host and records a
        real time per cycle in ``convergence``; ``mode="fused"`` runs the
        JAX package's device loop, on the card the captured cycle under a
        conditional WHILE node (one graph launch and one host wait per
        warm solve), with synthetic timestamps
        (``MultigridSolveContext.solve``); ``solver_timing`` then holds
        ``host_reads``, ``graph_launches``, ``graph_captures``,
        ``graph_capture_ms``, ``graph_build_ms`` and ``graph_pool_mib``.

        ``solver_timing`` holds this call's spans, in host ms:
        ``facade_pattern_key`` (the lookup: the pattern compared byte for
        byte with the facade's own copy of each candidate context's),
        ``facade_value_compare`` (the values against the owned copy; absent
        where the call built the context), ``solve_upload`` (with its
        child ``solve_deflation``, the host's share of the deflation: the
        rhs as a contiguous f64 array and the LHS's cached gate), ``cycles``
        (the loop), and ``solve_copy_back`` (the device's un-deflation and
        the copy); the counter ``deflated_columns`` (the columns whose
        constant mode the call removed); on the card ``loop_device``, the
        loop's device time between two CUDA events; ``solver_total``, the
        sum of ``solve_upload``, ``cycles`` and ``solve_copy_back``, plus
        ``plan_build`` and ``reduction`` where this call built the context
        or refreshed its values.  Those two and the ``setup_*`` keys are
        the context's latest set-up.  The context's layout counters, set
        once at its set-up: ``layout_slots`` and ``layout_nnz``, the stored
        slots (padding included) and structural nonzeros over every level
        operator's layout and both directions of every transfer, and
        ``levels_sliced_diag`` and ``levels_sliced_ell``, the levels the
        planner gave each layout.  ``facade_patterns_compared`` counts
        the stored patterns this call compared byte for byte (1 on a warm
        call with the newest context's pattern, 0 where none could match).
        Spans that launch no device work are also ranges of their name on
        a recording ``torch.profiler``'s host timeline, beside ranges with
        no key: ``update_galerkin``, ``update_spectral`` and
        ``update_coarse_factor`` (the host steps of a value refresh).

        A fused call runs ahead where ``lhs`` is the object the previous
        call received (held by a weak reference), that call found its
        context by the pattern with equal values, and the newest context
        admits ``lhs`` (hierarchy, shape, index lengths and dtypes): it
        solves on that context while the compare pool compares the pattern
        and the values, and keeps the answer only once both are equal.
        Where the values differ it refreshes them and solves again; where
        the pattern differs it looks up, refreshes or builds as any other
        call, without comparing that context again.  A caller that edits
        its matrix in place between calls therefore pays one discarded
        solve on the first call after each edit, the only case that loses;
        one that alternates matrices, or builds a new one each call, never
        runs ahead.  A traced call compares first: its thread launches
        every kernel from Python, and compare threads beside it slowed that
        thread by about what they saved (262k vertices, 3 columns, on an
        H100's host).  On a call that ran ahead ``facade_pattern_key`` and
        ``facade_value_compare`` are timed on the pool's thread that ran
        them (no range on the caller's profiler timeline), and
        ``facade_compare_wait`` is the caller's wait for them after its
        solve returned (a range; present only on calls that ran ahead).
        Every call sets ``facade_ran_ahead`` (1.0 where it solved before its
        compares confirmed the context, else 0.0) and ``facade_discarded``
        (1.0 where that answer was thrown away).  ``solver_total``,
        ``solve_upload``, ``cycles`` and ``solve_copy_back`` are those of
        the answer returned.
        """
        if not sp.issparse(lhs):
            lhs = sp.csr_matrix(lhs)
        rhs = np.asarray(rhs)
        squeeze = rhs.ndim == 1
        solve_kw = dict(tol=self.tolerance, criteria=self.stopping_criteria,
                        max_iter=self.max_iter, mode=mode)
        facade: dict = {"facade_ran_ahead": 0.0, "facade_discarded": 0.0}
        out = tried = None
        if (mode == "fused" and self._repeat is not None
                and self._repeat() is lhs and self._contexts):
            key, csr = next(reversed(self._contexts)), lhs.tocsr()
            if key.admits(self.hierarchy, csr):
                ctx = self._contexts[key]
                out = self._solve_ahead(key, ctx, csr, rhs, x0, solve_kw,
                                        facade)
                tried = key
        if out is None:
            found: dict = {}
            ctx = self._context(lhs, found, tried)
            # a discarded run-ahead's pattern compare adds to the lookup's
            for name, value in found.items():
                facade[name] = facade.get(name, 0) + value
            out = ctx.solve(rhs, x0, **solve_kw)
        x, iters, res, conv = out
        self.convergence = conv
        self.solver_timing = {**ctx.timing, **facade}
        if self.verbose:
            print(f"multigrid: {iters} cycles, residual {res:.3e}")
        return x[:, None] if (not squeeze and x.ndim == 1) else x

    def direct_solve(self, lhs, rhs, pardiso=False):
        """Host sparse direct solve (reference solverType 0/1).

        ``pardiso`` is accepted for API parity; both paths use the same
        factorization here (CHOLMOD when importable, else SuperLU).
        """
        if not sp.issparse(lhs):
            lhs = sp.csr_matrix(lhs)
        return direct_solve(lhs, np.asarray(rhs), timing=self.solver_timing)

    def cg_solve(self, lhs, rhs, max_iter: int = 10000):
        """Jacobi-preconditioned CG on the solver's device (reference
        solverType 4); iterations and residual land in ``solver_timing``.
        The solver keeps CG's captured 32-iteration unit for the last
        operator layout and right-hand-side shape (``cg_solve``'s
        ``cache``), so a repeated solve replays it from the start."""
        if not sp.issparse(lhs):
            lhs = sp.csr_matrix(lhs)
        return cg_solve(
            lhs, rhs, tol=self.tolerance, max_iter=max_iter, dtype=self.dtype,
            device=self.device, timing=self.solver_timing, cache=self._cg_units,
        )

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
