"""The port's comparison solvers: device CG and the host direct solve.

* ``cg_solve`` meets ``||b - A x|| <= tol ||b||`` (checked in f64 on the
  host, with 10% slack for the f32 compute) and lands within 10 tol of
  the JAX package's CG solution, relative to its norm; an (n, 3)
  right-hand side takes inner products over the whole array, as JAX's.
* ``max_iter`` is honoured exactly: one operator apply per iteration and
  no more (the JAX package runs whole 500-iteration chunks).
* A matrix with one dense row pads only its own 32-row slice of the
  sliced operator (SlicedDiag there, with no wide slice: past the fourth
  slot the dense row is its slice's one real lane), and CG solves on it.
* Without ``device``, CG runs on the card and raises where there is none.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu.solver import direct as ref_direct
from gravo_mg_tpu_torch import MultigridSolver, SlicedDiag
from gravo_mg_tpu_torch.solver import direct

torch.set_num_threads(2)


def _rhs(mesh, cols, seed=42):
    n = mesh["S"].shape[0]
    shape = (n,) if cols == 1 else (n, cols)
    return mesh["M"] @ np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize("tol", [1e-4, 1e-6])
def test_cg_meets_tol_and_matches_reference(sphere_mesh, cols, tol):
    m = sphere_mesh
    lhs = (m["M"] + 1e-3 * m["S"]).tocsr()
    rhs = _rhs(m, cols)
    timing = {}
    x = direct.cg_solve(lhs, rhs, tol=tol, device="cpu", timing=timing)
    assert x.shape == rhs.shape and x.dtype == np.float32
    res = np.linalg.norm(lhs @ x.astype(np.float64) - rhs) / np.linalg.norm(rhs)
    assert res <= 1.1 * tol, res
    assert 0 < timing["cg_iterations"] < 10000
    assert timing["cg_residual"] <= tol
    x_ref = np.asarray(ref_direct.cg_solve(lhs, rhs, tol=tol, dtype=jnp.float32))
    assert np.linalg.norm(x - x_ref) <= 10 * tol * np.linalg.norm(x_ref)


@pytest.mark.parametrize("max_iter", [100, 37])
def test_cg_honours_max_iter_exactly(sphere_mesh, max_iter, monkeypatch):
    m = sphere_mesh
    lhs = (1e-6 * m["M"] + m["S"]).tocsr()    # far from 1e-10 in max_iter
    calls = []
    plain = direct.spmv

    def counting(*args):
        calls.append(1)
        return plain(*args)

    monkeypatch.setattr(direct, "spmv", counting)   # every operator apply
    timing = {}
    x = direct.cg_solve(lhs, _rhs(m, 1), tol=1e-10, max_iter=max_iter,
                        device="cpu", timing=timing)
    assert np.isfinite(x).all()
    assert timing["cg_iterations"] == max_iter
    assert len(calls) == max_iter
    assert timing["cg_residual"] > 1e-10


def test_cg_dense_row_takes_ell_path():
    """The padding case an ELL layout is meant for: CG's operator stays
    sliced, its dense row widening only its own slice."""
    n = 1000
    main = np.full(n, 4.0)
    main[0] = 5.0
    A = sp.diags([main, -np.ones(n - 1), -np.ones(n - 1)], [0, -1, 1]).tolil()
    A[0, 2:] = 1e-3                          # one dense row (and column)
    A[2:, 0] = 1e-3
    A = A.tocsr()
    op = direct.cg_operator(A)
    assert isinstance(op, SlicedDiag)        # the byte rule's pick
    info = op.info()
    assert info["wide_slices"] == 0          # every slot fits int8 deltas
    # the dense row widens its own slice only: 32 rows x n slots
    assert info["max_width"] == n
    assert info["entries"] == 32 * n + 32 * 4 * (info["slices"] - 1)
    b = np.random.default_rng(0).standard_normal(n)
    x = direct.cg_solve(A, b, tol=1e-5, device="cpu")
    assert np.linalg.norm(A @ x - b) <= 1.1e-5 * np.linalg.norm(b)


def test_cg_zero_rhs_returns_zero(sphere_mesh):
    lhs = sphere_mesh["S"] + sphere_mesh["M"]
    timing = {}
    x = direct.cg_solve(lhs.tocsr(), np.zeros(lhs.shape[0]), device="cpu",
                        timing=timing)
    assert not x.any() and timing["cg_iterations"] == 0


def test_cg_defaults_to_cuda_and_raises_without_gpu(sphere_mesh, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lhs = (sphere_mesh["S"] + sphere_mesh["M"]).tocsr()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        direct.cg_solve(lhs, np.ones(lhs.shape[0]))


def test_facade_cg_and_direct(sphere_mesh):
    m = sphere_mesh
    lhs = (m["M"] + 1e-3 * m["S"]).tocsr()
    rhs = _rhs(m, 3)
    solver = MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=100,
                             device="cpu")
    x = solver.cg_solve(lhs, rhs, max_iter=500)
    assert np.linalg.norm(lhs @ x - rhs) <= 1.1e-4 * np.linalg.norm(rhs)
    assert solver.solver_timing["cg_iterations"] <= 500
    xd = solver.direct_solve(lhs, rhs)
    assert solver.solver_timing["direct_backend"] in ("cholmod", "superlu")
    np.testing.assert_allclose(xd, ref_direct.direct_solve(lhs, rhs), rtol=1e-10)
    assert np.linalg.norm(x - xd) <= 1e-3 * np.linalg.norm(xd)
