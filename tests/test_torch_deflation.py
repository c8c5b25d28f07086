"""Near-singular handling in the port: detection, deflation, coarse
nullspace fix.

The seven cases of ``tests/test_deflation.py`` on the port, each holding
the port's deflation coefficient to the JAX package's where both gates
pass, plus the case the port's absolute floor exists for: a singular
operator whose row sums are a few ulps of one sign.  The JAX package's
relative gate accepts it and divides by ~1e-12 (alpha ~1e11); the port
refuses to deflate and returns a finite solution with a bounded mean.
"""

import numpy as np
import scipy.sparse as sp
import torch

from gravo_mg_tpu.solver.multigrid import deflation_alpha as ref_alpha
from gravo_mg_tpu_torch import MultigridSolver
from gravo_mg_tpu_torch.solver.multigrid import deflation_alpha

torch.set_num_threads(2)


def _ctx(mesh, lhs, **kw):
    solver = MultigridSolver(mesh["V"], mesh["neigh"], mesh["M"],
                             lower_bound=80, device="cpu", **kw)
    return solver, solver._context(lhs)


def _assert_reference_alpha(ctx, rhs):
    rhs2 = rhs[:, None] if rhs.ndim == 1 else rhs
    got = deflation_alpha(ctx.row_sums, rhs2, ctx.diag_scale)
    want = ref_alpha(ctx.row_sums, rhs2)
    assert np.all(want != 0.0)
    np.testing.assert_array_equal(got, want)


def test_near_singular_detection(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    _, ctx_p = _ctx(sphere_mesh, (1e-6 * M + S).tocsr())
    assert ctx_p.near_singular and ctx_p.cfg.coarse_null_project
    _, ctx_s = _ctx(sphere_mesh, (M + 1e-3 * S).tocsr())
    assert not ctx_s.near_singular and not ctx_s.cfg.coarse_null_project


def test_poisson_solution_mean_is_exact(sphere_mesh):
    """alpha = sum(b)/sum(A@1) appears in the returned solution; its
    O(1/eta) size is out of the f32 cycle's reach without deflation."""
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rhs = (M @ np.random.default_rng(1).standard_normal((S.shape[0], 1)))[:, 0]
    solver, ctx = _ctx(sphere_mesh, lhs)
    _assert_reference_alpha(ctx, rhs)
    x, iters, res, _ = ctx.solve(rhs, tol=1e-4)
    assert res <= 1e-4
    assert solver.residual(lhs, rhs, x) <= 2e-4
    assert np.abs(x).max() > 1e2


def test_poisson_multi_rhs_deflation(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ np.random.default_rng(2).standard_normal((S.shape[0], 3))
    solver, ctx = _ctx(sphere_mesh, lhs)
    _assert_reference_alpha(ctx, rhs)
    x, iters, res, _ = ctx.solve(rhs, tol=1e-4)
    assert res <= 1e-4 and x.shape == rhs.shape
    assert solver.residual(lhs, rhs, x) <= 2e-4


def test_poisson_warm_start(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rhs = (M @ np.random.default_rng(3).standard_normal((S.shape[0], 1)))[:, 0]
    solver, ctx = _ctx(sphere_mesh, lhs)
    x1, _, _, _ = ctx.solve(rhs, tol=1e-4)
    x2, iters2, res2, _ = ctx.solve(rhs, x0=x1, tol=1e-4)
    assert iters2 <= 2 and res2 <= 1e-4


def test_fused_matches_traced_poisson(sphere_mesh):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rhs = (M @ np.random.default_rng(4).standard_normal((S.shape[0], 1)))[:, 0]
    solver, ctx = _ctx(sphere_mesh, lhs)
    x_t, it_t, res_t, _ = ctx.solve(rhs, tol=1e-4, mode="traced")
    x_f, it_f, res_f, _ = ctx.solve(rhs, tol=1e-4, mode="fused")
    assert it_t == it_f
    assert abs(res_t - res_f) < 1e-6
    assert np.allclose(x_t, x_f, rtol=1e-4, atol=1e-4 * np.abs(x_t).max())


def test_deflation_survives_mesh_rescaling(sphere_mesh):
    """A mesh scaled by 0.03: sum|A @ 1| = eta * area * s^2 ~ 1e-8 stays
    360x above the port's absolute floor (16 n eps64 mean|diag| ~ 3e-11),
    so deflation stays on and the solve converges as at scale 1."""
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    s = 0.03
    V2 = sphere_mesh["V"] * s
    M2 = (M * (s * s)).tocsr()    # mass scales with area; S is invariant
    lhs = (1e-6 * M2 + S).tocsr()
    rhs = (M2 @ np.random.default_rng(5).standard_normal((S.shape[0], 1)))[:, 0]
    solver = MultigridSolver(V2, sphere_mesh["neigh"], M2, lower_bound=150,
                             max_iter=30, device="cpu")
    x = solver.solve(lhs, rhs)
    _assert_reference_alpha(next(iter(solver._contexts.values())), rhs)
    assert solver.solver_timing["iterations"] < 25
    assert solver.residual(lhs, rhs, x) <= 1e-4


def test_deflation_alpha_rejects_roundoff_rowsums():
    """Sign-incoherent (roundoff-noise) row sums must not deflate; tiny
    but sign-coherent ones above the floor do, with or without a scale."""
    rng = np.random.default_rng(0)
    noise = rng.standard_normal(10000) * 1e-16
    b = rng.standard_normal((10000, 2))
    assert np.all(deflation_alpha(noise, b) == 0.0)
    assert np.all(deflation_alpha(noise, b, 1.0) == 0.0)
    genuine = np.full(10000, 1e-12)   # tiny but sign-coherent
    for scale in (None, 1.0):
        np.testing.assert_allclose(deflation_alpha(genuine, b, scale),
                                   b.sum(axis=0) / genuine.sum())


def test_sign_biased_singular_operator_is_not_deflated(sphere_mesh):
    """S + 4 ulp(diag S) on the closed sphere: every row sum is a few ulps
    and positive.  The JAX gate deflates with alpha ~ sum(b) / 5e-12; the
    port's floor refuses, and the solve returns a finite x whose mean
    stays bounded (it cannot converge: the system is singular to
    roundoff and the rhs is not mean-free)."""
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    d = S.diagonal()
    A = (S + sp.diags(4.0 * np.spacing(d))).tocsr()
    rs = np.asarray(A.sum(axis=1)).ravel()
    assert rs.min() > 0.0 and rs.sum() < 1e-11
    n = S.shape[0]
    rhs = M @ (np.random.default_rng(6).standard_normal((n, 1)) + 0.1)
    assert abs(rhs.sum()) > 1e-3
    assert abs(ref_alpha(rs, rhs)[0]) > 1e9
    assert np.all(deflation_alpha(rs, rhs, np.abs(d).mean()) == 0.0)
    solver = MultigridSolver(sphere_mesh["V"], sphere_mesh["neigh"], M,
                             lower_bound=100, max_iter=10, device="cpu")
    x = solver.solve(A, rhs)
    assert x.shape == rhs.shape and np.isfinite(x).all()
    assert abs(x.mean()) < 10.0
