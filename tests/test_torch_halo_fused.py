"""The halo solver's device loop (``HaloContext.solve(mode="fused")``) on
the CPU.

On the card one halo cycle (the cycle over the partitioned operators, the
all-gathered coarse solve, the all-reduced residual and the stop test) is
captured once as a CUDA graph and run under a conditional WHILE node that
reads the all-reduced stop flag; on the CPU ``StepGraph`` runs the same
step eagerly and the host reads the flag after each one, so these tests
run the code the card captures.

* Against the JAX package's ``HaloContext.solve`` (its ``shard_map``-wrapped
  ``while_loop``) on 8 virtual CPU devices, with the fixtures of
  ``tests/test_torch_halo.py``: smoothing and Poisson at d = 1, smoothing
  at d = 3, f32.  Equal cycles; x within 1e-4 of max|x| and its mean-free
  part within 1e-4 of the reference's (the summation orders differ, the
  tolerance ``test_halo_context_matches_reference`` states).
* Against the port's own host loop (``mode="traced"``): iterate, cycles and
  residual bit for bit (the same operations on the same buffers).
* The first iterate that meets tol, at tols that need 1, 2, 3 and 5
  cycles, against the traced loop and the JAX ``HaloContext``: exactly
  the cycles needed run; ``max_iter``, ``max_iter = 0`` (no cycle) and a
  tol met after one cycle.
* The loops are keyed by (columns, criteria, max_iter), and
  ``release_graphs`` drops them.
"""

import numpy as np
import pytest
import torch

from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu.parallel import halo as ref_halo
from gravo_mg_tpu.parallel.dist import make_solver_mesh as ref_mesh
from gravo_mg_tpu_torch import MultigridSolver, convert
from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh
from gravo_mg_tpu_torch.solver import multigrid as mg

torch.set_num_threads(2)

F32_TOL = 1e-4     # test_halo_context_matches_reference's bound


def _lhs(M, S, poisson):
    return ((1e-6 * M + S) if poisson else (M + 1e-3 * S)).tocsr()


def _mean_free_rel(x, ref):
    """max|x0 - ref0| / max|ref0| over the mean-free parts (the deflated
    constant dominates max|x| on a near-singular system)."""
    x0, r0 = x - x.mean(axis=0), ref - ref.mean(axis=0)
    return np.abs(x0 - r0).max() / max(np.abs(r0).max(), 1e-30)


@pytest.fixture(scope="module")
def medium(request):
    m = request.getfixturevalue("medium_mesh")
    rng = np.random.default_rng(0)
    return m, {1: m["M"] @ rng.standard_normal(m["V"].shape[0]),
               3: m["M"] @ rng.standard_normal((m["V"].shape[0], 3))}


@pytest.fixture(scope="module")
def ref_solver(medium):
    m, _ = medium
    return RefSolver(m["V"], m["neigh"], m["M"], lower_bound=200)


@pytest.mark.parametrize("poisson,d", [(False, 1), (True, 1), (False, 3)])
def test_halo_fused_matches_reference(medium, ref_solver, poisson, d):
    """The JAX HaloContext on 8 devices and the port's fused loop on 8
    partitions, same hierarchy and rhs."""
    m, rhs = medium
    rhs = rhs[d]
    lhs = _lhs(m["M"], m["S"], poisson)
    x_ref, it_ref, res_ref = ref_halo.HaloContext(
        ref_solver._context(lhs), ref_mesh(8)).solve(rhs, tol=1e-5, max_iter=50)
    ctx = mg.MultigridSolveContext(
        convert.hierarchy_from_reference(ref_solver.hierarchy), lhs, m["M"],
        mg.SolverConfig(), device="cpu")
    hctx = HaloContext(ctx, make_solver_mesh(8, "cpu"))
    x, it, res = hctx.solve(rhs, tol=1e-5, max_iter=50)
    assert hctx.timing["host_reads"] == it + 1   # the flag per cycle, the result
    assert it == it_ref < 50, (it, it_ref)
    assert res <= 1e-5 and abs(res - res_ref) <= 0.05 * res_ref
    assert x.shape == x_ref.shape
    assert np.abs(x - x_ref).max() / np.abs(x_ref).max() < F32_TOL
    assert _mean_free_rel(x, x_ref) < F32_TOL


@pytest.fixture(scope="module")
def small(sphere_mesh):
    """The 2562-vertex sphere, a two-level hierarchy of the port's own."""
    m = sphere_mesh
    solver = MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=100,
                             device="cpu")
    rng = np.random.default_rng(42)
    return m, solver, m["M"] @ rng.standard_normal((m["V"].shape[0], 3))


def _assert_same(traced, fused):
    assert fused[1] == traced[1] and fused[2] == traced[2]
    assert np.array_equal(fused[0], traced[0])


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("poisson,d", [(False, 1), (False, 3), (True, 1), (True, 3)])
def test_halo_fused_matches_traced_bitwise(small, poisson, d, D):
    m, solver, noise = small
    rhs = noise[:, 0] if d == 1 else noise
    hctx = HaloContext(solver._context(_lhs(m["M"], m["S"], poisson)),
                       make_solver_mesh(D, "cpu"))
    traced = hctx.solve(rhs, tol=1e-5, max_iter=50, mode="traced")
    assert "host_reads" not in hctx.timing and hctx.dispatched == traced[1]
    fused = hctx.solve(rhs, tol=1e-5, max_iter=50)
    _assert_same(traced, fused)
    assert fused[2] <= 1e-5 and fused[0].shape == rhs.shape
    # the CPU runs every step eagerly: nothing is captured or launched
    t = hctx.timing
    assert t["graph_captures"] == 0 and t["graph_launches"] == 0
    assert t["graph_pool_mib"] == 0 and t["graph_build_ms"] == 0
    assert t["cycles_ms"] > 0


@pytest.fixture(scope="module")
def small_ref(small):
    """The JAX solver on the same sphere (the same hierarchy as ``small``'s)."""
    m, _, _ = small
    return RefSolver(m["V"], m["neigh"], m["M"], lower_bound=100)


# tols at which the sphere's smoothing system over 4 partitions (residuals
# 2.8e-2, 1.0e-3, 4.0e-5, 1.6e-6, 1.5e-7) needs 1, 2, 3 and 5 cycles
TOL_FOR_CYCLES = {1: 1e-1, 2: 1e-2, 3: 1e-4, 5: 1e-6}


@pytest.mark.parametrize("cycles", [1, 2, 3, 5])
def test_halo_fused_returns_first_iterate_meeting_tol(small, small_ref, cycles):
    """The loop runs exactly the cycles the tol needs (no masked tail):
    iterate, cycles and residual equal the traced loop's, the cycles the
    JAX ``HaloContext``'s; on the CPU the host reads the flag after every
    cycle and the result once."""
    tol = TOL_FOR_CYCLES[cycles]
    m, solver, noise = small
    lhs = _lhs(m["M"], m["S"], False)
    hctx = HaloContext(solver._context(lhs), make_solver_mesh(4, "cpu"))
    traced = hctx.solve(noise[:, 0], tol=tol, mode="traced")
    fused = hctx.solve(noise[:, 0], tol=tol)
    _assert_same(traced, fused)
    assert fused[1] == cycles and hctx.dispatched == cycles
    assert hctx.timing["host_reads"] == cycles + 1
    x_ref, it_ref, res_ref = ref_halo.HaloContext(
        small_ref._context(lhs), ref_mesh(4)).solve(noise[:, 0], tol=tol)
    # cycles and iterate; the residuals are not compared: after 5 cycles
    # they sit at f32's floor (~1.1e-7), where the two summation orders
    # differ by a visible share
    assert it_ref == cycles and res_ref <= tol
    assert np.abs(fused[0] - x_ref).max() / np.abs(x_ref).max() < F32_TOL


@pytest.mark.parametrize("kw,want", [(dict(tol=1e-12, max_iter=3), 3),
                                     (dict(tol=0.5), 1), (dict(max_iter=0), 0)])
def test_halo_fused_max_iter_and_met_tol_match_traced(small, kw, want):
    m, solver, noise = small
    hctx = HaloContext(solver._context(_lhs(m["M"], m["S"], False)),
                       make_solver_mesh(4, "cpu"))
    traced = hctx.solve(noise[:, 0], mode="traced", **kw)
    fused = hctx.solve(noise[:, 0], **kw)
    _assert_same(traced, fused)
    assert fused[1] == want


def test_halo_fused_cache_keyed_and_released(small):
    m, solver, noise = small
    hctx = HaloContext(solver._context(_lhs(m["M"], m["S"], False)),
                       make_solver_mesh(4, "cpu"))
    hctx.solve(noise)
    hctx.solve(noise[:, 0])
    hctx.solve(noise[:, 0], criteria=0)
    hctx.solve(noise[:, 0])
    assert set(hctx._fused) == {(3, 2, 100), (None, 2, 100), (None, 0, 100)}
    hctx.release_graphs()
    assert hctx._fused == {}
    _assert_same(hctx.solve(noise[:, 0], mode="traced"), hctx.solve(noise[:, 0]))
    assert set(hctx._fused) == {(None, 2, 100)}
    with pytest.raises(ValueError, match="unknown solve mode"):
        hctx.solve(noise[:, 0], mode="eager")
