"""The port's device loop (``mode="fused"``) on the CPU.

On the card the loop's body (one cycle, its residual and the stop test)
is captured once as a CUDA graph and run under a conditional WHILE node
that reads the body's stop flag; on the CPU the same body runs eagerly
and the host reads the flag after each one, so these tests run the code
the card captures.

* Against the JAX package's ``fused_solve`` on identical level operators
  (carried over by ``convert.levels_from_reference``), V, F and W cycles
  at d = 1 and 3 in f32: the same ``iters``; the iterate and the
  residual trace within 1e-4 relative, the tolerance that
  ``test_cycle_matches_reference`` states for one f32 cycle.  The loop
  adds no arithmetic of its own, and the cycles contract the difference
  one cycle leaves, so the whole loop stays within one cycle's bound.
  The trace is compared as a vector (relative to its norm): its last
  entries sit near 1e-6, where one cycle's f32 rounding is a visible
  share of each entry.
* Against the port's own ``traced`` loop: iterate, ``iters`` and trace
  bitwise equal (the same operations on the same buffers).
* Stopping: ``max_iter`` reached, ``tol`` met after the first cycle,
  ``max_iter = 0`` (no cycle: x0 back, as JAX's ``while_loop`` returns
  it), and tols that need 1, 2, 3 and 5 cycles: the loop runs exactly the
  cycles it needs, against the traced loop and the JAX ``fused_solve``.
* The context's cache of loops is dropped by ``update_lhs``.
* MinQuad in fused mode; CG's 32-iteration unit against the loop it
  replaced, at a ``max_iter`` that is not a multiple of 32.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravo_mg_tpu.hierarchy.builder import build_hierarchy as ref_build
from gravo_mg_tpu.solver import multigrid as ref_mg
from gravo_mg_tpu.solver.residual import residual_denominator as ref_den
from gravo_mg_tpu_torch import MinQuadWithFixedMG, MultigridSolver, convert, sparse
from gravo_mg_tpu_torch.solver import direct
from gravo_mg_tpu_torch.solver import multigrid as mg
from gravo_mg_tpu_torch.solver.device_loop import StepGraph
from gravo_mg_tpu_torch.utils.meshgen import icosphere
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_voronoi
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

torch.set_num_threads(2)

F32_TOL = 1e-4      # test_cycle_matches_reference's f32 bound for one cycle


def _system(mesh, poisson=False, cols=1, seed=42):
    S, M = mesh["S"], mesh["M"]
    lhs = (1e-6 * M + S).tocsr() if poisson else (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(seed).standard_normal((S.shape[0], cols))
    return lhs, rhs[:, 0] if cols == 1 else rhs


@pytest.fixture(scope="module")
def ref_hierarchy(sphere_mesh):
    return ref_build(sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=100)


class _Pair:
    """One f32 system as a JAX reference context and the port's operators
    carried over from it, with ``fused_solve`` of each."""

    def __init__(self, mesh, hierarchy, cycle, d):
        lhs, rhs = _system(mesh, cols=d)
        self.ctx = ref_mg.MultigridSolveContext(
            hierarchy, lhs, mesh["M"], ref_mg.SolverConfig(cycle_type=cycle),
            dtype=jnp.float32)
        assert self.ctx.cfg.num_levels >= 2
        self.b = rhs.astype(np.float32)
        self.x0 = np.zeros_like(self.b)
        self.den = ref_den(self.ctx.M, self.ctx.Minv_diag, jnp.asarray(self.b), 2)
        levels, coarse = convert.levels_from_reference(
            self.ctx.levels, self.ctx.coarse_op, device="cpu")
        cfg = mg.SolverConfig(**{f.name: getattr(self.ctx.cfg, f.name)
                                 for f in dataclasses.fields(mg.SolverConfig)})
        self.port_ops = (cfg, levels, coarse,
                         convert.operator_from_reference(self.ctx.M),
                         torch.from_numpy(np.array(self.ctx.Minv_diag)))

    def ref(self, tol, max_iter):
        c = self.ctx
        x, iters, _, trace = ref_mg.fused_solve(
            c.cfg, c.levels, c.coarse_op, c.M, c.Minv_diag, jnp.asarray(self.b),
            jnp.asarray(self.x0), self.den, jnp.asarray(tol, jnp.float32), 2,
            max_iter)
        iters = int(iters)
        return np.asarray(x), iters, np.asarray(trace)[:iters]

    def port(self, tol, max_iter):
        x, iters, _, trace = mg.fused_solve(
            *self.port_ops, torch.from_numpy(self.b), torch.from_numpy(self.x0),
            torch.from_numpy(np.array(self.den)), tol, 2, max_iter)
        return x.numpy(), iters, np.asarray(trace, dtype=np.float32)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("cycle,d", [(0, 1), (0, 3), (1, 1), (1, 3), (2, 1), (2, 3)])
def test_fused_matches_reference(sphere_mesh, ref_hierarchy, cycle, d):
    pair = _Pair(sphere_mesh, ref_hierarchy, cycle, d)
    x_ref, it_ref, tr_ref = pair.ref(1e-5, 40)
    x, it, tr = pair.port(1e-5, 40)
    assert 2 <= it == it_ref < 40
    assert x.shape == x_ref.shape and x.dtype == np.float32
    assert _rel(x, x_ref) <= F32_TOL
    assert _rel(tr, tr_ref) <= F32_TOL
    assert tr[-1] <= 1e-5 < tr[-2]


@pytest.mark.parametrize("case", ["max_iter", "first_cycle"])
def test_fused_stops_as_reference(sphere_mesh, ref_hierarchy, case):
    """``max_iter`` reached (tol out of f32's reach): iters == max_iter;
    tol met after the first cycle: iters == 1."""
    pair = _Pair(sphere_mesh, ref_hierarchy, 0, 1)
    tol, max_iter = (1e-12, 3) if case == "max_iter" else (0.5, 10)
    x_ref, it_ref, tr_ref = pair.ref(tol, max_iter)
    x, it, tr = pair.port(tol, max_iter)
    assert it == it_ref == (3 if case == "max_iter" else 1)
    assert len(tr) == it and _rel(tr, tr_ref) <= F32_TOL
    assert _rel(x, x_ref) <= F32_TOL


def test_fused_max_iter_zero_returns_x0(sphere_mesh, ref_hierarchy):
    """``max_iter = 0``: the cond fails before the first body, so no cycle
    runs and the loop returns its initial carry, as ``lax.while_loop``
    does (the JAX ``fused_solve`` itself cannot trace a zero-length
    trace buffer)."""
    pair = _Pair(sphere_mesh, ref_hierarchy, 0, 1)
    pair.x0 = np.random.default_rng(7).standard_normal(pair.b.shape).astype(np.float32)
    x, iters, res, trace = mg.fused_solve(
        *pair.port_ops, torch.from_numpy(pair.b), torch.from_numpy(pair.x0),
        torch.from_numpy(np.array(pair.den)), 1e-5, 2, 0)
    assert iters == 0 and trace == [] and res == math.inf
    assert np.array_equal(x.numpy(), pair.x0)


@pytest.fixture(scope="module")
def port_solver(sphere_mesh):
    m = sphere_mesh
    return MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=100,
                           device="cpu")


def _both_modes(ctx, rhs, **kw):
    traced = ctx.solve(rhs, mode="traced", **kw)
    dispatched_traced = ctx.dispatched
    fused = ctx.solve(rhs, mode="fused", **kw)
    return traced, fused, dispatched_traced


def _assert_same(traced, fused):
    (x_t, it_t, res_t, conv_t), (x_f, it_f, res_f, conv_f) = traced, fused
    assert it_f == it_t and res_f == res_t
    assert np.array_equal(x_f, x_t)
    assert [r for _, r in conv_f] == [r for _, r in conv_t]


@pytest.mark.parametrize("poisson,d", [(False, 1), (False, 3), (True, 1), (True, 3)])
def test_fused_matches_traced_bitwise(sphere_mesh, port_solver, poisson, d):
    lhs, rhs = _system(sphere_mesh, poisson=poisson, cols=d)
    ctx = port_solver._context(lhs)
    traced, fused, _ = _both_modes(ctx, rhs, tol=1e-5)
    _assert_same(traced, fused)
    assert ctx.timing["trace_timestamps_synthetic"] == 1.0
    stamps = [t for t, _ in fused[3]]
    assert stamps == sorted(stamps) and len(stamps) == fused[1]
    # the CPU runs every step eagerly: nothing is captured or launched
    assert ctx.timing["graph_captures"] == 0 and ctx.timing["graph_launches"] == 0
    assert ctx.timing["graph_build_ms"] == 0


# tols at which the sphere's smoothing system (trace 2.7e-2, 1.0e-3, 3.9e-5,
# 1.6e-6, 1.4e-7) needs 1, 2, 3 and 5 cycles
TOL_FOR_CYCLES = {1: 1e-1, 2: 1e-2, 3: 1e-4, 5: 1e-6}


@pytest.mark.parametrize("cycles", [1, 2, 3, 5])
def test_fused_returns_first_iterate_meeting_tol(sphere_mesh, port_solver,
                                                 ref_hierarchy, cycles):
    """The loop runs exactly the cycles the tol needs (no masked tail):
    iters, res and trace equal the traced loop's, the iterate bit for bit,
    and the cycles equal the JAX ``fused_solve``'s; on the CPU the host
    reads the flag after every cycle and the result once."""
    tol = TOL_FOR_CYCLES[cycles]
    lhs, rhs = _system(sphere_mesh)
    ctx = port_solver._context(lhs)
    traced, fused, _ = _both_modes(ctx, rhs, tol=tol)
    _assert_same(traced, fused)
    assert fused[1] == cycles and ctx.dispatched == cycles
    assert ctx.timing["host_reads"] == cycles + 1
    # the stop is where the traced loop's is: the residual before it is above tol
    trace = [r for _, r in fused[3]]
    assert trace[-1] <= tol and all(r > tol for r in trace[:-1])
    _, it_ref, tr_ref = _Pair(sphere_mesh, ref_hierarchy, 0, 1).ref(tol, 40)
    assert it_ref == cycles and _rel(np.asarray(trace), tr_ref) <= F32_TOL


def test_fused_max_iter_and_met_tol_match_traced(sphere_mesh, port_solver):
    lhs, rhs = _system(sphere_mesh)
    ctx = port_solver._context(lhs)
    for kw, want in ((dict(tol=1e-12, max_iter=3), 3), (dict(tol=0.5), 1),
                     (dict(max_iter=0), 0)):
        traced, fused, _ = _both_modes(ctx, rhs, **kw)
        _assert_same(traced, fused)
        assert fused[1] == want


def test_fused_zero_level_hierarchy_solves_once():
    V, F = icosphere(2, bump=0.1)
    S, M = cotan_laplacian(V, F), mass_voronoi(V, F)
    solver = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=1000,
                             device="cpu")
    lhs = (M + 1e-3 * S).tocsr()
    ctx = solver._context(lhs)
    assert ctx.cfg.num_levels == 0
    traced, fused, _ = _both_modes(ctx, M @ V)
    _assert_same(traced, fused)
    assert fused[1] == 1 and ctx.dispatched == 1 and not ctx._fused


def test_fused_cache_keyed_and_dropped_by_update_lhs(sphere_mesh, port_solver):
    lhs, rhs = _system(sphere_mesh, cols=3)
    ctx = port_solver._context(lhs)
    ctx.release_graphs()
    ctx.solve(rhs, mode="fused")
    ctx.solve(rhs[:, 0], mode="fused")
    ctx.solve(rhs[:, 0], mode="fused", criteria=0)
    x_old = ctx.solve(rhs[:, 0], mode="fused")[0]
    assert set(ctx._fused) == {(3, 2, 100), (None, 2, 100), (None, 0, 100)}
    lhs2 = (sphere_mesh["M"] + 3e-2 * sphere_mesh["S"]).tocsr()
    ctx.update_lhs(lhs2)
    assert ctx._fused == {}
    traced, fused, _ = _both_modes(ctx, rhs[:, 0])
    _assert_same(traced, fused)
    assert ctx.residual(rhs[:, 0], fused[0]) <= 1e-4
    assert _rel(fused[0], x_old) > 1e-2      # the new system's solution
    ctx.update_lhs(lhs)                       # back, for the module's other tests


def test_min_quad_fused_matches_traced(sphere_mesh, port_solver):
    m = sphere_mesh
    n = m["V"].shape[0]
    rng = np.random.default_rng(3)
    known = rng.choice(n, size=n // 20, replace=False)
    Y = rng.standard_normal(known.size)
    B = m["M"] @ rng.standard_normal(n)
    mq = MinQuadWithFixedMG(port_solver, (m["S"] + 1e-3 * m["M"]).tocsr(), known,
                            tol=1e-4, max_iter=20)
    traced = mq.solve(B, Y)
    fused = mq.solve(B, Y, mode="fused")
    _assert_same(traced, fused)
    assert np.array_equal(fused[0][known], Y) and 1 < fused[1] < 20
    assert mq.ctx.timing["trace_timestamps_synthetic"] == 1.0


def test_step_graph_runs_eagerly_on_cpu():
    count = []
    g = StepGraph(lambda: count.append(1), "cpu")
    g.run(3)
    g.run(0)
    g.run(2)
    g.release()
    assert len(count) == 5 and g.captures == g.replays == 0 and g.graph is None


def test_step_graph_loop_on_cpu():
    """``loop`` runs the step while the flag holds (the caller set it),
    reading the flag after each step and the counter once at the end."""
    flag = torch.ones((), dtype=torch.bool)
    counter = torch.zeros((), dtype=torch.int64)
    limit = [4]

    def step():
        counter.add_(1)
        torch.lt(counter, limit[0], out=flag)

    g = StepGraph(step, "cpu")
    assert g.loop(flag, counter) == (4, 5)
    limit[0] = 1                       # the first step stops the loop
    flag.fill_(True)
    counter.zero_()
    assert g.loop(flag, counter) == (1, 2)
    assert g.captures == g.launches == 0 and g.graph is None


def _cg_loop_before(lhs, rhs, tol, max_iter):
    """CG's loop as it was before its 32-iteration unit became one step:
    the direction update after the check, skipped on a restart."""
    A = direct.cg_operator(lhs)
    b = torch.from_numpy(np.ascontiguousarray(rhs, dtype=np.float32))
    dinv = torch.from_numpy(1.0 / np.maximum(np.asarray(lhs.diagonal()), 1e-30))
    dinv = dinv.to(torch.float32)
    if b.ndim == 2:
        dinv = dinv[:, None]
    x = torch.zeros_like(b)
    bnorm = float(torch.linalg.vector_norm(b))
    thresh2 = (tol * bnorm) ** 2
    iters = 0
    r = b.clone()
    z = dinv * r
    p = z.clone()
    rz = torch.sum(r * z)
    while iters < max_iter:
        Ap = sparse.spmv(A, p)
        alpha = rz / torch.sum(p * Ap)
        x.addcmul_(p, alpha)
        r.addcmul_(Ap, alpha, value=-1.0)
        iters += 1
        if iters % direct.CHECK_EVERY == 0 or iters == max_iter:
            rr = float(torch.sum(r * r))
            if rr <= thresh2:
                r = b - sparse.spmv(A, x)
                rr = float(torch.sum(r * r))
                if rr <= thresh2 or iters == max_iter:
                    break
                z = dinv * r
                p = z.clone()
                rz = torch.sum(r * z)
                continue
        z = dinv * r
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x.numpy(), iters


@pytest.mark.parametrize("poisson,cols,tol,max_iter", [
    (True, 1, 1e-10, 45),     # stops at max_iter: one unit, then 13 eager iterations
    (True, 3, 1e-10, 70),     # two units and a remainder of 6
    (False, 1, 1e-4, 1000),   # converges at a check
])
def test_cg_unit_matches_loop_before(sphere_mesh, poisson, cols, tol, max_iter):
    lhs, rhs = _system(sphere_mesh, poisson=poisson, cols=cols)
    timing = {}
    x = direct.cg_solve(lhs, rhs, tol=tol, max_iter=max_iter, device="cpu",
                        timing=timing)
    x_before, it_before = _cg_loop_before(lhs, rhs, tol, max_iter)
    assert timing["cg_iterations"] == it_before
    assert (it_before == max_iter) == poisson
    assert np.isfinite(x).all() and np.array_equal(x, x_before)
    assert timing["cg_graph_replays"] == 0     # the CPU runs every unit eagerly


def test_cg_cache_keeps_unit_per_shape(sphere_mesh):
    """A caller's cache holds one unit: a solve of the same layout and
    right-hand-side shape loads its operator into it (new values too) and
    gives what a solve without the cache gives; another shape replaces it."""
    lhs, rhs = _system(sphere_mesh, poisson=True, cols=1)
    cache = {}
    kw = dict(tol=1e-10, max_iter=70, device="cpu")
    x1 = direct.cg_solve(lhs, rhs, cache=cache, **kw)
    (unit,) = cache.values()
    assert np.array_equal(direct.cg_solve(lhs, rhs, cache=cache, **kw), x1)
    lhs2 = (2.0 * lhs).tocsr()
    x2 = direct.cg_solve(lhs2, rhs, cache=cache, **kw)
    assert list(cache.values()) == [unit]
    assert np.array_equal(x2, direct.cg_solve(lhs2, rhs, **kw))
    _, rhs3 = _system(sphere_mesh, poisson=True, cols=3)
    x3 = direct.cg_solve(lhs, rhs3, cache=cache, **kw)
    assert len(cache) == 1 and unit not in cache.values()
    assert np.array_equal(x3, direct.cg_solve(lhs, rhs3, **kw))
