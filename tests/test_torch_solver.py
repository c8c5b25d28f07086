"""The port's solve path against the JAX package.

* One V/F/W cycle on identical level operators (carried over from a
  reference context by convert.py): f32 within 1e-4 of ||x||, f64 within
  1e-10 (summation order and Chebyshev coefficient rounding differ).
* Facade solves on the 10k sphere, smoothing and Poisson, and with every
  level planned as DiagEll: equal cycle counts, per-cycle residuals within
  5% relative, host-verified residual <= 1e-4.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu.hierarchy.builder import build_hierarchy as ref_build
from gravo_mg_tpu.solver import multigrid as ref_mg
from gravo_mg_tpu_torch import MultigridSolver, convert
from gravo_mg_tpu_torch.solver import multigrid as mg

torch.set_num_threads(2)


def _system(mesh, poisson=False, cols=1, seed=42):
    S, M = mesh["S"], mesh["M"]
    lhs = (1e-6 * M + S).tocsr() if poisson else (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(seed).standard_normal((S.shape[0], cols))
    return lhs, rhs


@pytest.fixture(scope="module")
def ref_hierarchy(sphere_mesh):
    return ref_build(sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=100)


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-4), (np.float64, 1e-10)])
@pytest.mark.parametrize("cycle,d", [(0, 1), (1, 3), (2, 3)])   # V, F, W
def test_cycle_matches_reference(sphere_mesh, ref_hierarchy, cycle, d, dtype, tol):
    lhs, rhs = _system(sphere_mesh, cols=d)
    ctx = ref_mg.MultigridSolveContext(
        ref_hierarchy, lhs, sphere_mesh["M"],
        ref_mg.SolverConfig(cycle_type=cycle), dtype=jnp.dtype(dtype),
    )
    assert ctx.cfg.num_levels >= 2
    rng = np.random.default_rng(7)
    b = (rhs[:, 0] if d == 1 else rhs).astype(dtype)
    x0 = (1e-3 * rng.standard_normal(b.shape)).astype(dtype)
    ref = np.asarray(ref_mg.cycle_step(
        ctx.cfg, ctx.levels, ctx.coarse_op, jnp.asarray(b), jnp.asarray(x0)
    ))
    levels, coarse = convert.levels_from_reference(ctx.levels, ctx.coarse_op)
    cfg = mg.SolverConfig(**{
        f.name: getattr(ctx.cfg, f.name) for f in dataclasses.fields(mg.SolverConfig)
    })
    got = mg.cycle_step(cfg, levels, coarse, torch.from_numpy(b),
                        torch.from_numpy(x0)).numpy()
    assert got.dtype == dtype and got.shape == ref.shape
    err = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert err <= tol, err


@pytest.mark.parametrize("case", ["smoothing", "poisson", "diag_levels"])
def test_facade_solve_matches_reference(medium_mesh, case, monkeypatch):
    m = medium_mesh
    lhs, rhs = _system(m, poisson=case == "poisson")
    kw = {}
    if case == "diag_levels":
        # Every level as DiagEll: the reference needs both overrides (its
        # size gate and its TPU-only tile gate), the port one argument.
        monkeypatch.setenv("GRAVO_MG_DIAG_MIN_GROUPS", "1")
        monkeypatch.setenv("GRAVO_MG_DIAG_ANY_TG", "1")
        kw["diag_min_groups"] = 1
    mode = "fused" if case == "poisson" else "traced"
    ref = RefSolver(m["V"], m["neigh"], m["M"], lower_bound=200)
    x_ref = ref.solve(lhs, rhs, mode=mode)
    port = MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=200,
                           device="cpu", **kw)
    x = port.solve(lhs, rhs, mode=mode)
    assert x.shape == x_ref.shape and np.isfinite(x).all()
    assert port.hierarchy.dof == ref.hierarchy.dof
    iters = port.solver_timing["iterations"]
    assert iters == ref.solver_timing["iterations"]
    trace = [c[1] for c in port.convergence]
    trace_ref = [c[1] for c in ref.convergence]
    assert len(trace) == iters
    np.testing.assert_allclose(trace, trace_ref, rtol=0.05)
    assert port.residual(lhs, rhs, x) <= 1e-4
    ctx = next(iter(port._contexts.values()))
    kinds = {type(lvl.A).__name__ for lvl in ctx.levels}
    assert kinds == ({"DiagEll"} if case == "diag_levels" else {"ShuffleEll"})


def test_facade_reuses_context_and_updates_values(sphere_mesh):
    """Same pattern, new values: one context, value-only refresh; a
    (n, 3) right-hand side keeps its shape."""
    m = sphere_mesh
    port = MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=100,
                           device="cpu")
    for tau in (1e-3, 1e-2):
        lhs = (m["M"] + tau * m["S"]).tocsr()
        rhs = m["M"] @ m["V"]
        x = port.solve(lhs, rhs)
        assert x.shape == rhs.shape
        assert port.residual(lhs, rhs, x) <= 1e-4
    assert len(port._contexts) == 1


def test_cuda_device_raises_without_gpu(sphere_mesh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = sphere_mesh
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        MultigridSolver(m["V"], m["neigh"], m["M"])   # device="cuda" default


def test_unported_entry_points_raise(sphere_mesh):
    m = sphere_mesh
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        MultigridSolver(m["V"], m["neigh"], m["M"], sig06=True, device="cpu")
    port = MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=100,
                           device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port.cg_solve(m["S"], m["M"] @ m["V"])


@pytest.mark.parametrize("poisson", [False, True])
def test_zero_level_hierarchy_and_warm_start(poisson):
    """A mesh at/below lower_bound has no levels: one refined coarse
    apply solves it (reference multigrid.py:912-932); a warm start x0 is
    deflated on the host.  Solutions agree with the reference to 1e-4."""
    from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_voronoi
    from gravo_mg_tpu_torch.utils.meshgen import icosphere
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

    V, F = icosphere(3)                      # 642 vertices < lower_bound
    S, M = cotan_laplacian(V, F), mass_voronoi(V, F)
    neigh = neighbors_from_faces(F)
    lhs = (1e-6 * M + S).tocsr() if poisson else (M + 1e-3 * S).tocsr()
    rhs = (M @ V)[:, 0]
    x0 = np.random.default_rng(1).standard_normal(len(V))
    port = MultigridSolver(V, neigh, M, device="cpu")
    ref = RefSolver(V, neigh, M)
    assert port.hierarchy.dof == ref.hierarchy.dof == [len(V)]
    x = port.solve(lhs, rhs, x0=x0)
    x_ref = ref.solve(lhs, rhs, x0=x0)
    assert x.shape == rhs.shape and port.residual(lhs, rhs, x) <= 1e-4
    assert np.linalg.norm(x - x_ref) <= 1e-4 * np.linalg.norm(x_ref)
