"""The solve's constant-mode deflation on the device.

The gate and ``sum(A @ 1)`` are computed once per LHS
(``deflation_denominator``, kept by ``_analyze_lhs``); each solve forms
alpha, the deflated rhs and the un-deflated answer on the device in f64.
Held here on the sphere fixtures, d = 1 and 3, in both loop modes: the
solve's alpha against the host ``deflation_alpha`` (the device sums in
its own order: 1e-12 relative), exactly 0 where the gate refuses; the
returned x bit for bit the loop's iterate in f64 plus that alpha added on
the host; a warm start's ``x0 - alpha`` formed in f64 before the cast;
and ``deflated_columns`` following a value refresh that flips the gate.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu_torch import MultigridSolver
from gravo_mg_tpu_torch.solver import multigrid as mg

torch.set_num_threads(2)

MODES = ["traced", "fused"]


def _solver(mesh, **kw):
    return MultigridSolver(mesh["V"], mesh["neigh"], mesh["M"], lower_bound=100,
                           device="cpu", **kw)


def _rhs(mesh, d, seed, shift=0.0):
    n = mesh["S"].shape[0]
    r = mesh["M"] @ (np.random.default_rng(seed).standard_normal((n, d)) + shift)
    return r[:, 0] if d == 1 else r


def _refused_lhs(mesh):
    """The sign-biased singular operator of
    ``test_sign_biased_singular_operator_is_not_deflated``: S + 4 ulp of
    its diagonal, every row sum a few ulps and positive."""
    S = mesh["S"]
    return (S + sp.diags(4.0 * np.spacing(S.diagonal()))).tocsr()


class _Spy:
    """Records the solve's device deflation (its alpha), the loop's start
    and the iterates it hands back: ``FusedLoop.run``'s x in the fused
    mode, each ``cycle_step``'s in the traced one."""

    def __init__(self, monkeypatch, mode):
        self.mode = mode
        self.alpha, self.x0, self.iterates = [], [], []
        deflate, run, step = mg.device_deflation, mg.FusedLoop.run, mg.cycle_step

        def device_deflation(*a):
            out = deflate(*a)
            self.alpha.append(out[0].clone())
            return out

        def fused_run(loop, b, x0, den, tol):
            self.x0.append(x0.clone())
            out = run(loop, b, x0, den, tol)
            self.iterates.append(out[0].clone())
            return out

        def cycle_step(cfg, levels, coarse, b, x):
            if not self.iterates:
                self.x0.append(x.clone())
            out = step(cfg, levels, coarse, b, x)
            self.iterates.append(out.clone())
            return out

        monkeypatch.setattr(mg, "device_deflation", device_deflation)
        if mode == "fused":
            monkeypatch.setattr(mg.FusedLoop, "run", fused_run)
        else:
            monkeypatch.setattr(mg, "cycle_step", cycle_step)

    def answer(self, iters):
        """The iterate the solve returned: the fused loop's, or the
        traced loop's accepted cycle (its lookahead cycle discarded)."""
        return self.iterates[-1] if self.mode == "fused" else self.iterates[iters - 1]


def _undeflated_on_host(y, alpha):
    """The loop's iterate widened to f64 and alpha added on the host."""
    y64 = y.double().numpy()
    return (y64[:, None] if y64.ndim == 1 else y64) + alpha[None, :]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [1, 3])
def test_device_alpha_matches_host_and_the_answer_is_undeflated_bitwise(
        sphere_mesh, monkeypatch, mode, d):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rhs = _rhs(sphere_mesh, d, seed=11)
    solver = _solver(sphere_mesh)
    ctx = solver._context(lhs)
    spy = _Spy(monkeypatch, mode)
    x, iters, res, _ = ctx.solve(rhs, tol=1e-4, mode=mode)
    assert res <= 1e-4 and x.shape == rhs.shape and x.dtype == np.float64
    (alpha,) = spy.alpha
    assert alpha.dtype == torch.float64 and alpha.shape == (d,)
    rhs2 = rhs[:, None] if d == 1 else rhs
    want = mg.deflation_alpha(ctx.row_sums, rhs2, ctx.diag_scale)
    assert np.all(want != 0.0)
    np.testing.assert_allclose(alpha.numpy(), want, rtol=1e-12, atol=0)
    got = _undeflated_on_host(spy.answer(iters), alpha.numpy())
    assert np.array_equal(x, got[:, 0] if d == 1 else got)
    assert ctx.timing["deflated_columns"] == d


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [1, 3])
def test_refused_gate_leaves_the_rhs_and_the_answer_alone(
        sphere_mesh, monkeypatch, mode, d):
    A = _refused_lhs(sphere_mesh)
    rhs = _rhs(sphere_mesh, d, seed=6, shift=0.1)
    solver = _solver(sphere_mesh, max_iter=3)
    ctx = solver._context(A)
    assert ctx.deflation_denom is None
    spy = _Spy(monkeypatch, mode)
    x, iters, _, _ = ctx.solve(rhs, tol=1e-4, mode=mode)
    (alpha,) = spy.alpha
    assert alpha.shape == (d,) and torch.equal(alpha, torch.zeros(d, dtype=torch.float64))
    assert ctx.timing["deflated_columns"] == 0
    got = spy.answer(iters).double().numpy()
    assert np.isfinite(x).all() and np.array_equal(x, got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("d", [1, 3])
def test_warm_start_is_deflated_in_f64_before_the_cast(
        sphere_mesh, monkeypatch, mode, d):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    lhs = (1e-6 * M + S).tocsr()
    rhs = _rhs(sphere_mesh, d, seed=12)
    solver = _solver(sphere_mesh)
    ctx = solver._context(lhs)
    x1 = ctx.solve(rhs, tol=1e-4, mode=mode)[0]
    spy = _Spy(monkeypatch, mode)
    x2, iters2, res2, _ = ctx.solve(rhs, x0=x1, tol=1e-4, mode=mode)
    assert iters2 <= 2 and res2 <= 1e-4
    (alpha,) = spy.alpha
    a = alpha.numpy()
    y0 = ((x1[:, None] if d == 1 else x1) - a[None, :])   # host f64 cancellation
    want = torch.from_numpy(y0[:, 0] if d == 1 else y0).to(ctx.dtype)
    assert ctx.dtype == torch.float32 and torch.equal(spy.x0[0], want)
    # the f32 iterate alone cannot hold x0: |x0| ~ |alpha| >> |x0 - alpha|
    assert np.abs(x1).max() > 1e2 * np.abs(y0).max()


@pytest.mark.parametrize("d", [1, 3])
def test_value_refresh_that_flips_the_gate_flips_deflated_columns(sphere_mesh, d):
    S, M = sphere_mesh["S"], sphere_mesh["M"]
    poisson, refused = (1e-6 * M + S).tocsr(), _refused_lhs(sphere_mesh)
    for A in (poisson, refused):
        A.sort_indices()
    # one pattern: the second LHS is a value refresh of the first context
    assert np.array_equal(poisson.indptr, refused.indptr)
    assert np.array_equal(poisson.indices, refused.indices)
    rhs = _rhs(sphere_mesh, d, seed=13, shift=0.1)
    solver = _solver(sphere_mesh, max_iter=3)
    seen = []
    for A in (poisson, refused, poisson):
        solver.solve(A, rhs, mode="fused")
        seen.append(solver.solver_timing["deflated_columns"])
    assert len(solver._contexts) == 1
    assert seen == [d, 0, d]
