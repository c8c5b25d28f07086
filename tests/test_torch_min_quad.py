"""The port's MinQuadWithFixedMG against the JAX package and SuperLU.

The three cases of ``tests/test_min_quad.py``, each run through both
packages on the same hierarchy (the builds are bit-identical):

* f64, tol 5e-6 (absolute l2): the port's solution within 1e-4 of a
  SuperLU solve of the reduced system, and the JAX cycle count;
* f32 defaults (tol 1e-3, 20 cycles): the JAX cycle count, per-cycle
  residuals within 5% relative, the maximum principle;
* f64 multi-RHS (n, 3): within 1e-4 of SuperLU.
"""

import jax.numpy as jnp
import numpy as np
import scipy.sparse.linalg as spla
import torch

from gravo_mg_tpu import MinQuadWithFixedMG as RefMinQuad
from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu_torch import MinQuadWithFixedMG, MultigridSolver
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_voronoi
from gravo_mg_tpu_torch.utils.meshgen import icosphere
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

torch.set_num_threads(2)


def _setup(subdiv=4, lower_bound=120, f64=False):
    V, F = icosphere(subdiv, bump=0.15)
    S, M = cotan_laplacian(V, F), mass_voronoi(V, F)
    neigh = neighbors_from_faces(F)
    port = MultigridSolver(V, neigh, M, lower_bound=lower_bound, device="cpu",
                           dtype=torch.float64 if f64 else torch.float32)
    ref = RefSolver(V, neigh, M, lower_bound=lower_bound,
                    dtype=jnp.float64 if f64 else jnp.float32)
    assert port.hierarchy.dof == ref.hierarchy.dof
    return V, S, M, port, ref


def _direct(lhs, mq, B, Y):
    u, k = mq.unknown, mq.known
    return spla.spsolve(lhs[u][:, u].tocsc(), B[u] - lhs[u][:, k] @ Y)


def test_min_quad_matches_direct_and_reference():
    V, S, M, port, ref = _setup(f64=True)
    n = V.shape[0]
    rng = np.random.default_rng(3)
    known = rng.choice(n, size=n // 20, replace=False)
    Y = rng.standard_normal(known.size)
    lhs = (S + 1e-3 * M).tocsr()
    B = M @ rng.standard_normal(n)

    mq = MinQuadWithFixedMG(port, lhs, known, tol=5e-6, max_iter=60)
    x, iters, res, conv = mq.solve(B, Y)
    x_ref, iters_ref, _, _ = RefMinQuad(ref, lhs, known, tol=5e-6,
                                        max_iter=60).solve(B, Y)
    assert np.array_equal(x[known], Y)
    x_dir = _direct(lhs, mq, B, Y)
    err = np.linalg.norm(x[mq.unknown] - x_dir) / np.linalg.norm(x_dir)
    assert err < 1e-4, f"relative error {err:.2e} after {iters} cycles"
    assert res <= 5e-6 and len(conv) == iters
    assert iters == iters_ref
    assert np.linalg.norm(x - x_ref) <= 1e-6 * np.linalg.norm(x_ref)


def test_min_quad_default_tolerance_and_trace():
    V, S, M, port, ref = _setup(subdiv=3, lower_bound=80)
    n = V.shape[0]
    known = np.arange(0, n, 37)
    Y = np.sin(V[known, 0] * 3.0)
    lhs = (S + 1e-2 * M).tocsr()
    B = np.zeros(n)

    mq = MinQuadWithFixedMG(port, lhs, known)  # tol 1e-3, 20 iters
    assert mq.ctx.device == port.device
    x, iters, res, conv = mq.solve(B, Y)
    _, iters_ref, _, conv_ref = RefMinQuad(ref, lhs, known).solve(B, Y)
    assert iters <= 20 and res <= 1e-3 and len(conv) == iters
    assert iters == iters_ref
    np.testing.assert_allclose([c[1] for c in conv], [c[1] for c in conv_ref],
                               rtol=0.05)
    # Laplace interpolation stays within the data range (maximum principle,
    # loose check).
    assert x.min() >= Y.min() - 0.2 and x.max() <= Y.max() + 0.2


def test_min_quad_multi_rhs():
    V, S, M, port, ref = _setup(subdiv=3, lower_bound=80, f64=True)
    n = V.shape[0]
    rng = np.random.default_rng(11)
    known = rng.choice(n, size=25, replace=False)
    Y = rng.standard_normal((known.size, 3))
    lhs = (S + 1e-3 * M).tocsr()
    B = M @ rng.standard_normal((n, 3))

    mq = MinQuadWithFixedMG(port, lhs, known, tol=5e-6, max_iter=60)
    x, iters, res, _ = mq.solve(B, Y)
    x_ref, iters_ref, _, _ = RefMinQuad(ref, lhs, known, tol=5e-6,
                                        max_iter=60).solve(B, Y)
    assert x.shape == (n, 3) and np.array_equal(x[known], Y)
    x_dir = _direct(lhs, mq, B, Y)
    err = np.linalg.norm(x[mq.unknown] - x_dir) / np.linalg.norm(x_dir)
    assert err < 1e-4
    assert iters == iters_ref
    assert np.linalg.norm(x - x_ref) <= 1e-6 * np.linalg.norm(x_ref)
