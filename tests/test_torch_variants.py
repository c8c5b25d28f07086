"""The port's SIG06 and ablation hierarchies against the JAX package.

* ``_avg_edge_length`` (the radius rule; f32 in both) within 1e-6
  relative: the reference sums on the device, the port exactly in f64 and
  rounds once.
* SIG06 and ablation (nearest, random, nested with 4 points) hierarchies:
  equal dof, samples, labels and coarse graphs; prolongations within 1e-12.
* Facade solves with ``sig06=True`` / ``ablation=True``: equal cycle
  counts, per-cycle residuals within 5% relative, host residual <= 1e-4.
* The port's solve path on a JAX-built SIG06 hierarchy carried over by
  ``convert.hierarchy_from_reference`` takes the JAX cycle count.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu.hierarchy import variants as ref_variants
from gravo_mg_tpu.hierarchy.builder import _avg_edge_length as ref_avg_edge
from gravo_mg_tpu.solver import multigrid as ref_mg
from gravo_mg_tpu_torch import MultigridSolver, convert
from gravo_mg_tpu_torch.hierarchy import variants
from gravo_mg_tpu_torch.hierarchy.builder import _avg_edge_length
from gravo_mg_tpu_torch.solver import multigrid as mg

torch.set_num_threads(2)


def assert_same_hierarchy(got, ref, tol=1e-12):
    assert got.dof == ref.dof and len(got.dof) >= 2
    for a, b in zip(got.levels, ref.levels):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.coarse_neigh, b.coarse_neigh)
        np.testing.assert_array_equal(a.coarse_points, b.coarse_points)
        Ua, Ub = a.U.to_scipy(), b.U.to_scipy()
        assert Ua.shape == Ub.shape
        assert abs(Ua - Ub).max() <= tol


@pytest.mark.parametrize("mesh", ["sphere_mesh", "medium_mesh"])
def test_avg_edge_length_matches_reference(mesh, request):
    m = request.getfixturevalue(mesh)
    got = _avg_edge_length(m["V"], m["neigh"])
    ref = float(ref_avg_edge(jnp.asarray(m["V"], jnp.float32),
                             jnp.asarray(m["neigh"])))
    assert abs(got - ref) <= 1e-6 * ref


BUILDS = {
    "sig06": ({}, {}),
    "ablation": ({}, {}),
    "ablation_random": ({"random_points": True, "seed": 5},) * 2,
    "ablation_nested_4": ({"num_points": 4, "nested": True},) * 2,
}


@pytest.mark.parametrize("mesh,lower_bound", [
    ("sphere_mesh", 100),     # 2562 vertices
    ("medium_mesh", 200),     # 10242 vertices
])
@pytest.mark.parametrize("kind", list(BUILDS))
def test_variant_hierarchy_matches_reference(kind, mesh, lower_bound, request):
    m = request.getfixturevalue(mesh)
    kw, ref_kw = BUILDS[kind]
    if kind == "sig06":
        got = variants.build_hierarchy_sig06(m["V"], m["neigh"],
                                             lower_bound=lower_bound)
        ref = ref_variants.build_hierarchy_sig06(m["V"], m["neigh"],
                                                 lower_bound=lower_bound)
    else:
        got = variants.build_hierarchy_ablation(
            m["V"], m["neigh"], lower_bound=lower_bound, **kw)
        ref = ref_variants.build_hierarchy_ablation(
            m["V"], m["neigh"], lower_bound=lower_bound, **ref_kw)
    assert_same_hierarchy(got, ref)


@pytest.mark.parametrize("kw,poisson", [
    ({"sig06": True}, False),
    ({"sig06": True}, True),
    ({"ablation": True}, False),
    ({"ablation": True, "ablation_random": True}, True),
])
def test_facade_solve_on_variant_matches_reference(sphere_mesh, kw, poisson):
    m = sphere_mesh
    S, M = m["S"], m["M"]
    lhs = (1e-6 * M + S).tocsr() if poisson else (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(42).standard_normal((S.shape[0], 1))
    ref = RefSolver(m["V"], m["neigh"], M, lower_bound=100, **kw)
    x_ref = ref.solve(lhs, rhs)
    port = MultigridSolver(m["V"], m["neigh"], M, lower_bound=100,
                           device="cpu", **kw)
    x = port.solve(lhs, rhs)
    assert port.hierarchy.dof == ref.hierarchy.dof
    assert x.shape == x_ref.shape and np.isfinite(x).all()
    iters = port.solver_timing["iterations"]
    assert iters == ref.solver_timing["iterations"]
    np.testing.assert_allclose([c[1] for c in port.convergence],
                               [c[1] for c in ref.convergence], rtol=0.05)
    assert port.residual(lhs, rhs, x) <= 1e-4


def test_port_solves_on_reference_sig06_hierarchy(sphere_mesh):
    """State carried across: a JAX-built SIG06 hierarchy, converted, runs
    through the port's context in the JAX context's cycle count."""
    m = sphere_mesh
    lhs = (m["M"] + 1e-3 * m["S"]).tocsr()
    rhs = m["M"] @ np.random.default_rng(3).standard_normal(lhs.shape[0])
    ref_h = ref_variants.build_hierarchy_sig06(m["V"], m["neigh"],
                                               lower_bound=100)
    ref_ctx = ref_mg.MultigridSolveContext(ref_h, lhs, m["M"],
                                           ref_mg.SolverConfig())
    _, ref_iters, _, _ = ref_ctx.solve(rhs, tol=1e-6, max_iter=50)
    ctx = mg.MultigridSolveContext(convert.hierarchy_from_reference(ref_h),
                                   lhs, m["M"], mg.SolverConfig(), device="cpu")
    x, iters, res, _ = ctx.solve(rhs, tol=1e-6, max_iter=50)
    assert iters == ref_iters and res <= 1e-6
    assert ctx.residual(rhs, x) <= 1e-6
