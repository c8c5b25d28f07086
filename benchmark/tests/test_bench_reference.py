"""The reference's recomputation on a tiny mesh against the port's CPU path:
the frozen copies give the port's inputs, and a flow step of the port meets
the reference's system and normalization."""

import numpy as np
import pytest

from benchmark.reference import check, mesh
from gravo_mg_tpu_torch.models.problems import ConformalFlow
from gravo_mg_tpu_torch.utils import laplacian, meshgen, normalize


def _torus():
    return mesh.torus_mesh(24, 12, r=0.5)


def test_frozen_copies_equal_the_ports_functions():
    V, F = _torus()
    V2, F2 = meshgen.torus_mesh(24, 12, r=0.5)
    assert np.array_equal(V, V2) and np.array_equal(F, F2)
    Vn = mesh.normalize_area(V, F)
    assert np.array_equal(Vn, normalize.normalize_area(V, F))
    for ours, port in ((mesh.cotan_laplacian, laplacian.cotan_laplacian),
                       (mesh.mass_barycentric, laplacian.mass_barycentric)):
        assert (ours(Vn, F) != port(Vn, F)).nnz == 0


@pytest.mark.parametrize("system", ["poisson", "smoothing"])
def test_system_matrix_is_the_configurations(system):
    V, F = _torus()
    S, M = mesh.cotan_laplacian(V, F), mesh.mass_barycentric(V, F)
    cfg = {"system": system, "eta": 1e-6, "tau": 1e-3}
    want = 1e-6 * M + S if system == "poisson" else M + 1e-3 * S
    assert abs(mesh.system_matrix(cfg, S, M) - want).max() == 0


def _flow(V_in, F):
    from gravo_mg_tpu_torch import MultigridSolver

    return ConformalFlow(V_in, F, tau=1e-3, solver_factory=lambda V0, n, M:
                         MultigridSolver(V0, n, M, lower_bound=64,
                                         dtype=__import__("torch").float64,
                                         device="cpu"))


def test_flow_steps_of_the_port_meet_the_reference():
    V, F = _torus()
    V_in = V + 1e-3 * np.random.default_rng(7).standard_normal(V.shape)
    flow = _flow(V_in, F)
    ref = check.FlowReference(V_in, F, 1e-3)
    assert np.abs(flow.V - ref.V0).max() <= 1e-15
    answers = []
    inner = flow.solver.solve

    def record(*a, **k):
        x = inner(*a, **k)
        answers.append((x, flow.solver.solver_timing["residue"]))
        return x

    flow.solver.solve = record
    samples, prev = [], None
    for _ in range(3):
        out = flow.step(tol=1e-4)
        samples.append((prev, *answers[-1], out))
        prev = out
    judge = check.judge_flow(samples, ref, {"residual": 1e-4,
                                            "residue_gap": 1e-9,
                                            "position_gap": 1e-13})
    assert judge.correct, judge.numbers()
    # the reference's system at the start is the one the port assembled
    lhs, M, rhs = ref.system(ref.V0)
    assert abs(lhs - (flow.solver.mass + 1e-3 * flow.S)).max() <= 1e-15


def test_residual_columns_is_the_m_norm_criterion():
    V, F = _torus()
    M = mesh.mass_barycentric(V, F)
    A = (M + 1e-3 * mesh.cotan_laplacian(V, F)).tocsr()
    b = M @ np.ones((V.shape[0], 2))
    x = np.zeros_like(b)
    assert np.allclose(check.residual_columns(A, M, b, x), 1.0)
    x = np.linalg.solve(A.toarray(), b)
    assert check.residual_columns(A, M, b, x).max() < 1e-12
