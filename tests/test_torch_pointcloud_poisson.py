"""Poisson on a raw point cloud in f64 through the port's facade, on the CPU.

The setting of the benchmark's point-cloud configuration at n = 4096: the
benchmark's frozen point-cloud inputs (sphere, seed 3, points in the order
they are sampled, kNN Laplacian over k = 12), the stiffness's neighbours, a
nested hierarchy, ``1e-6 M + S`` and ``mode="fused"``.  The port's answer is
held to the criterion-2 residual recomputed with SciPy, to the benchmark's
plain-torch f64 Jacobi-PCG run to 1e-10 in the M-norm within the bound each
residual implies, and to the residual it reports; in f32 it misses that
report's gap.  The context's layout counters equal a recount of its layout
arrays on the cloud and on a small torus.
"""

import numpy as np
import pytest
import scipy.sparse.linalg as sla
import torch

from benchmark.reference import inputs
from benchmark.reference.solver import ReferenceSolver
from gravo_mg_tpu_torch import MultigridSolver
from gravo_mg_tpu_torch.sparse import ShuffleTransfer, SlicedDiag, SlicedEll
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_barycentric
from gravo_mg_tpu_torch.utils.meshgen import torus_mesh
from gravo_mg_tpu_torch.utils.neighbors import (
    neighbors_from_faces,
    neighbors_from_stiffness,
)

torch.set_num_threads(2)

ETA, TOL = 1e-6, 1e-4
GAP = 1e-7            # the configuration's residue_gap limit
SEEDS = [0, 1, 2**31 + 7]
CLOUD = {"kind": "point_cloud", "n": 4096, "seed": 3, "surface": "sphere",
         "k": 12, "order": "sampled"}


@pytest.fixture(scope="module")
def cloud():
    inp = inputs.make(CLOUD)
    return inp.V, inp.S, inp.M, (ETA * inp.M + inp.S).tocsr()


def _solver(cloud, dtype):
    V, S, M, _ = cloud
    return MultigridSolver(V, neighbors_from_stiffness(S), M, nested=True,
                           lower_bound=64, tolerance=TOL, dtype=dtype,
                           device="cpu")


@pytest.fixture(scope="module")
def solvers(cloud):
    return {dtype: _solver(cloud, dtype)
            for dtype in (torch.float64, torch.float32)}


def _rhs(cloud, seed):
    M = cloud[2]
    return M @ np.random.default_rng(seed).standard_normal(M.shape[0])


def _solve(solvers, cloud, seed, dtype=torch.float64):
    solver = solvers[dtype]
    x = solver.solve(cloud[3], _rhs(cloud, seed), mode="fused")
    return x, solver.solver_timing["residue"]


def _criterion(cloud, rhs, x) -> float:
    """sqrt(r' M r / b' M b), r = A x - b, in f64 with SciPy."""
    _, _, M, lhs = cloud
    r = lhs @ x - rhs
    return float(np.sqrt((r @ (M @ r)) / (rhs @ (M @ rhs))))


@pytest.mark.parametrize("seed", SEEDS)
def test_f64_answer_meets_the_criterion(solvers, cloud, seed):
    x, _ = _solve(solvers, cloud, seed)
    assert x.dtype == np.float64
    assert _criterion(cloud, _rhs(cloud, seed), x) <= TOL


@pytest.fixture(scope="module")
def spectrum(cloud):
    """The two smallest eigenpairs of ``A v = lambda M v`` (M-orthonormal):
    the near-constant mode at ~ETA and the first nonzero one."""
    _, _, M, lhs = cloud
    lam, vec = sla.eigsh(lhs, k=2, M=M.tocsc(), sigma=0, which="LM")
    return lam, vec[:, 0]


def _error_bound(cloud, spectrum, rhs, x) -> float:
    """The largest M-norm distance from x to the exact solution that x's
    residual r = A x - b allows: with the generalized eigenpairs of
    (A, M), ||A^{-1} r||_M^2 = sum_i (v_i' r)^2 / lam_i^2 is at most
    (v_1' r / lam_1)^2 + (r' M^{-1} r) / lam_2^2."""
    _, _, M, lhs = cloud
    (lam1, lam2), v1 = spectrum
    r = lhs @ x - rhs
    rest = np.sqrt(r @ (r / M.diagonal())) / lam2
    return float(np.hypot((v1 @ r) / lam1, rest))


@pytest.mark.parametrize("seed", SEEDS)
def test_f64_answer_agrees_with_the_reference(solvers, cloud, spectrum, seed):
    _, _, M, lhs = cloud
    rhs = _rhs(cloud, seed)
    x, _ = _solve(solvers, cloud, seed)
    ref = ReferenceSolver(M, torch.float64, "cpu", tolerance=1e-10,
                          max_iter=20000)
    x_ref = ref.solve(lhs, rhs)
    assert _criterion(cloud, rhs, x_ref) <= 1e-10
    e = x - x_ref
    dist = float(np.sqrt(e @ (M @ e)))
    bound = (_error_bound(cloud, spectrum, rhs, x)
             + _error_bound(cloud, spectrum, rhs, x_ref))
    assert dist <= bound, (dist, bound)


@pytest.mark.parametrize("seed", SEEDS)
def test_f64_reports_the_residual_it_stopped_at(solvers, cloud, seed):
    x, claimed = _solve(solvers, cloud, seed)
    true = _criterion(cloud, _rhs(cloud, seed), x)
    assert abs(claimed - true) / true <= GAP, (claimed, true)


@pytest.mark.parametrize("seed", SEEDS)
def test_f32_misses_the_reported_residuals_gap(solvers, cloud, seed):
    x, claimed = _solve(solvers, cloud, seed, torch.float32)
    true = _criterion(cloud, _rhs(cloud, seed), x)
    assert abs(claimed - true) / true > GAP, (claimed, true)


def _recount(ctx) -> dict:
    """The counters from the context's layout arrays."""
    slots = nnz = 0
    kinds = {"sdiag": 0, "sliced": 0}
    for level in ctx.levels:
        A = level.A
        if isinstance(A, SlicedDiag):
            kinds["sdiag"] += 1
            slots += A.delta.numel()
        else:
            assert isinstance(A, SlicedEll)
            kinds["sliced"] += 1
            slots += A.col.numel()
        nnz += A.nnz
    for t in ctx.transfers:
        assert isinstance(t, ShuffleTransfer)
        slots += t.U.col.numel() + t.UT.col.numel()
        nnz += t.U.nnz + t.UT.nnz
    return {"layout_slots": slots, "layout_nnz": nnz,
            "levels_sliced_diag": kinds["sdiag"],
            "levels_sliced_ell": kinds["sliced"]}


@pytest.mark.parametrize("case", ["cloud", "torus"])
def test_layout_counters_equal_a_recount(cloud, case):
    if case == "cloud":
        V, S, M, lhs = cloud
        neigh = neighbors_from_stiffness(S)
        kw = dict(nested=True, lower_bound=64)
    else:
        V, F = torus_mesh(64, 32)
        S, M = cotan_laplacian(V, F), mass_barycentric(V, F)
        lhs, neigh = (ETA * M + S).tocsr(), neighbors_from_faces(F)
        # a finest level of 16 row groups of 128 may take SlicedDiag
        kw = dict(lower_bound=64, diag_min_groups=16)
    solver = MultigridSolver(V, neigh, M, dtype=torch.float64, device="cpu", **kw)
    solver.solve(lhs, M @ np.ones(V.shape[0]), mode="fused")
    ctx = next(iter(solver._contexts.values()))
    t = solver.solver_timing
    want = _recount(ctx)
    assert {k: t[k] for k in want} == want
    assert want["levels_sliced_diag"] + want["levels_sliced_ell"] == len(ctx.levels)
    assert t["layout_slots"] >= t["layout_nnz"] > 0
    if case == "torus":
        assert want["levels_sliced_diag"] >= 1 and want["levels_sliced_ell"] >= 1
