"""The port's SIG21 decimation hierarchy against the JAX package.

Both packages compile the same ``ssp_native.cpp``, so the native
decimator's output, the hierarchy and the block prolongations must be
identical; the pure-Python decimator and its barycentric replay too (same
numpy code).  Through the facade, SIG21 solves take the JAX cycle count.
"""

import numpy as np
import pytest
import torch

from gravo_mg_tpu import Hierarchy as RefHierarchyType
from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu import native as ref_native
from gravo_mg_tpu.hierarchy import sig21 as ref_sig21
from gravo_mg_tpu.solver import multigrid as ref_mg
from gravo_mg_tpu_torch import Hierarchy, MultigridSolver, convert, native
from gravo_mg_tpu_torch.hierarchy import sig21
from gravo_mg_tpu_torch.solver import multigrid as mg
from gravo_mg_tpu_torch.utils.meshgen import icosphere

torch.set_num_threads(2)


def _assert_arrays_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("dec_type", [0, 1, 2])   # qslim, midpoint, removal
def test_ssp_decimate_native_matches_reference(sphere_mesh, dec_type):
    V, F = sphere_mesh["V"], sphere_mesh["F"]
    target = len(V) // 4
    got = native.ssp_decimate_native(V, F, target, dec_type)
    ref = ref_native.ssp_decimate_native(V, F, target, dec_type)
    assert ref is not None
    _assert_arrays_equal(got, ref)
    assert got[0].shape[0] <= target + 8


def test_ssp_decimate_native_rejects_bad_input():
    with pytest.raises(ValueError):
        native.ssp_decimate_native(np.zeros((4, 3)), np.zeros((0, 3), np.int64), 2, 1)
    with pytest.raises(ValueError):
        native.ssp_decimate_native(np.zeros((3, 3)), np.array([[0, 1, 5]]), 2, 1)


@pytest.mark.parametrize("dec_type", [0, 1, 2, "midpoint"])
def test_build_sig21_hierarchy_matches_reference(sphere_mesh, dec_type):
    V, F = sphere_mesh["V"], sphere_mesh["F"]
    got = sig21.build_sig21_hierarchy(V, F, min_coarsest=100, dec_type=dec_type)
    ref = ref_sig21.build_sig21_hierarchy(V, F, min_coarsest=100,
                                          dec_type=dec_type)
    assert got.dof == ref.dof and got.num_levels >= 2
    assert got.neigh.shape == ref.neigh.shape == (0, 1)
    for a, b in zip(got.levels, ref.levels):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.coarse_points, b.coarse_points)
        np.testing.assert_array_equal(a.coarse_neigh, b.coarse_neigh)
        Ua, Ub = a.U.to_scipy(), b.U.to_scipy()
        assert (Ua != Ub).nnz == 0
    for a, b in zip(sig21.block_prolongations(got, dim=3),
                    ref_sig21.block_prolongations(ref, dim=3)):
        assert a.shape == b.shape and (a != b).nnz == 0


def test_build_sig21_rejects_unknown_dec_type(sphere_mesh):
    with pytest.raises(ValueError):
        sig21.build_sig21_hierarchy(sphere_mesh["V"], sphere_mesh["F"],
                                    dec_type=7)


@pytest.mark.parametrize("strategy", ["midpoint", "qslim", "vertexremoval"])
def test_python_decimator_matches_reference(strategy):
    V, F = icosphere(3, bump=0.1)          # 642 vertices: the heap is Python
    got = sig21._decimate(V, F, 200, strategy)
    ref = ref_sig21._decimate(V, F, 200, strategy)
    _assert_arrays_equal(got, ref)
    Vc, Fc, kept_map, _ = got
    _assert_arrays_equal(
        sig21._barycentric_assignment(V, Vc, Fc, kept_map),
        ref_sig21._barycentric_assignment(V, Vc, Fc, kept_map),
    )


def test_sig21_facade_matches_reference(medium_mesh):
    m = medium_mesh
    lhs = (m["M"] + 1e-3 * m["S"]).tocsr()
    rhs = m["M"] @ np.random.default_rng(0).standard_normal(lhs.shape[0])
    ref = RefSolver(m["V"], m["neigh"], m["M"], lower_bound=500,
                    tolerance=1e-6, max_iter=60)
    ref.construct_sig21_hierarchy(m["F"])
    ref.toggle_hierarchy(RefHierarchyType.SIG21)
    x_ref = ref.solve(lhs, rhs)
    port = MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=500,
                           tolerance=1e-6, max_iter=60, device="cpu")
    port.construct_sig21_hierarchy(m["F"])
    assert port.hierarchy_timing["sig21_hierarchy"] > 0   # written into OURS
    port.toggle_hierarchy(Hierarchy.SIG21)
    assert port.hierarchy.dof == ref.hierarchy.dof
    assert port.hierarchy_timing["sig21_hierarchy"] > 0
    x = port.solve(lhs, rhs)
    assert port.solver_timing["iterations"] == ref.solver_timing["iterations"]
    np.testing.assert_allclose([c[1] for c in port.convergence],
                               [c[1] for c in ref.convergence], rtol=0.05)
    assert port.residual(lhs, rhs, x) <= 1e-6
    assert np.linalg.norm(x - x_ref) <= 1e-4 * np.linalg.norm(x_ref)
    # SIG21BARY shares the hierarchy; OURS comes back
    port.toggle_hierarchy(Hierarchy.SIG21BARY)
    assert port.hierarchy is port._hierarchy_sig21
    port.toggle_hierarchy(Hierarchy.OURS)
    assert port.hierarchy is port._hierarchy_ours
    assert port.level_edges[0].shape[1] == 2


def test_toggle_sig21_without_constructing_asserts(sphere_mesh):
    m = sphere_mesh
    port = MultigridSolver(m["V"], m["neigh"], m["M"], lower_bound=100,
                           device="cpu")
    for kind in (Hierarchy.SIG21, Hierarchy.SIG21BARY):
        with pytest.raises(AssertionError, match="construct_sig21_hierarchy"):
            port.toggle_hierarchy(kind)
    assert port.hierarchy is port._hierarchy_ours


def test_port_solves_on_reference_sig21_hierarchy(sphere_mesh):
    """State carried across: a JAX-built SIG21 hierarchy (neigh (0, 1), no
    cluster distances) converts and solves in the JAX cycle count."""
    m = sphere_mesh
    lhs = (1e-6 * m["M"] + m["S"]).tocsr()
    rhs = m["M"] @ np.random.default_rng(4).standard_normal((lhs.shape[0], 2))
    ref_h = ref_sig21.build_sig21_hierarchy(m["V"], m["F"], min_coarsest=100)
    conv = convert.hierarchy_from_reference(ref_h)
    assert conv.neigh.shape == (0, 1) and conv.dof == ref_h.dof
    assert all(lvl.cluster_dist is None for lvl in conv.levels)
    ref_ctx = ref_mg.MultigridSolveContext(ref_h, lhs, m["M"],
                                           ref_mg.SolverConfig())
    _, ref_iters, _, _ = ref_ctx.solve(rhs, tol=1e-4, max_iter=100)
    ctx = mg.MultigridSolveContext(conv, lhs, m["M"], mg.SolverConfig(),
                                   device="cpu")
    x, iters, res, _ = ctx.solve(rhs, tol=1e-4, max_iter=100)
    assert iters == ref_iters and res <= 1e-4
    assert x.shape == rhs.shape and ctx.residual(rhs, x) <= 2e-4
