"""The port's host half against the JAX package: hierarchy, slot layouts,
plan arrays, Galerkin chain, host helpers, and the import boundary.

Both packages run the same native C++ and numpy code on the same seeded
inputs, so everything here is compared for exact equality except the
Galerkin chain (tolerance 1e-12 relative to its largest entry).
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu import sparse as ref_sparse
from gravo_mg_tpu.hierarchy.builder import build_hierarchy as ref_build
from gravo_mg_tpu.solver import multigrid as ref_mg
from gravo_mg_tpu_torch import convert, sparse
from gravo_mg_tpu_torch.hierarchy.builder import build_hierarchy
from gravo_mg_tpu_torch.solver import multigrid as mg

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand_coo(n, m, nnz, bw, seed, dup=True):
    """Random (banded when bw is set) COO triplets, with duplicates."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    if bw is None:
        cols = rng.integers(0, m, nnz)
    else:
        cols = np.clip(rows * m // n + rng.integers(-bw, bw + 1, nnz), 0, m - 1)
    if dup:
        rows = np.concatenate([rows, rows[: nnz // 10]])
        cols = np.concatenate([cols, cols[: nnz // 10]])
    return rows.astype(np.int64), cols.astype(np.int64), rng.standard_normal(rows.size)


def _assert_same(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mesh,lower_bound", [
    ("sphere_mesh", 100),     # 2562 vertices
    ("medium_mesh", 200),     # 10242 vertices
])
def test_build_hierarchy_matches_reference(mesh, lower_bound, request):
    m = request.getfixturevalue(mesh)
    ref = ref_build(m["V"], m["neigh"], lower_bound=lower_bound, seed=3)
    got = build_hierarchy(m["V"], m["neigh"], lower_bound=lower_bound, seed=3)
    assert got.dof == ref.dof and len(got.dof) >= 3
    for a, b in zip(got.levels, ref.levels):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.coarse_neigh, b.coarse_neigh)
        np.testing.assert_array_equal(a.coarse_points, b.coarse_points)
        np.testing.assert_array_equal(a.stats, b.stats)
        Ua, Ub = a.U.to_scipy(), b.U.to_scipy()
        np.testing.assert_array_equal(Ua.indptr, Ub.indptr)
        np.testing.assert_array_equal(Ua.indices, Ub.indices)
        np.testing.assert_array_equal(Ua.data, Ub.data)
    # convert.py carries the reference hierarchy over unchanged
    conv = convert.hierarchy_from_reference(ref)
    assert conv.dof == ref.dof
    for a, b in zip(conv.levels, got.levels):
        assert (a.U.to_scipy() != b.U.to_scipy()).nnz == 0


@pytest.mark.parametrize("n,m,nnz,bw,seed", [
    (1000, 1000, 7000, 30, 0),      # banded square
    (3000, 400, 9000, 20, 1),       # restriction-shaped
    (400, 3000, 5000, 40, 2),       # prolongation-shaped
    (2000, 2000, 6000, None, 3),    # fully random
    (90, 90, 300, None, 4),         # under one row group
])
def test_shuffle_layout_matches_reference(n, m, nnz, bw, seed):
    rows, cols, _ = _rand_coo(n, m, nnz, bw, seed)
    _assert_same(sparse._shuffle_layout(rows, cols, n, m),
                 ref_sparse._shuffle_layout(rows, cols, n, m))


@pytest.mark.parametrize("tg", [32, 128, 512])
@pytest.mark.parametrize("n,nnz,bw,seed", [
    (5000, 40000, 300, 5),
    (4000, 12000, None, 6),
])
def test_diag_layout_matches_reference(tg, n, nnz, bw, seed):
    rows, cols, _ = _rand_coo(n, n, nnz, bw, seed)
    _assert_same(sparse._diag_layout(rows, cols, n, n, tg=tg),
                 ref_sparse._diag_layout(rows, cols, n, n, tg=tg))


def _ell_of(A):
    A = A.tocsr()
    A.sum_duplicates()
    A.sort_indices()
    return ref_mg._ell_pattern(A)


def test_plan_arrays_match_reference():
    rows, cols, vals = _rand_coo(6000, 6000, 40000, 60, 7, dup=False)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(6000, 6000))
    idx, mask = _ell_of(A)
    _assert_same(sparse.diag_plan_arrays(idx, mask, 6000),
                 ref_sparse.diag_plan_arrays(idx, mask, 6000))


@pytest.mark.parametrize("which", ["general", "diagonal"])
def test_shuffle_from_scipy_matches_reference(which):
    if which == "diagonal":   # the mass-matrix fast path
        A = sp.diags(np.random.default_rng(8).random(3000) + 0.5).tocsr()
    else:
        rows, cols, vals = _rand_coo(2500, 700, 12000, 25, 9)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(2500, 700))
    ref = ref_sparse.shuffle_from_scipy(A, dtype=jnp.float32)
    got = sparse.shuffle_from_scipy(A, dtype=torch.float32)
    _assert_same((got.q, got.r, got.v), (ref.q, ref.r, ref.v))
    assert (got.nrows, got.ncols) == (ref.nrows, ref.ncols)
    if which == "general":   # the diagonal path never pads
        assert sparse.shuffle_from_scipy(A, size_cap=1) is None


def test_galerkin_chain_and_host_helpers_match_reference(medium_mesh):
    m = medium_mesh
    hier = build_hierarchy(m["V"], m["neigh"], lower_bound=200, seed=0)
    Us = [lvl.U.to_scipy() for lvl in hier.levels]
    lhs = (1e-6 * m["M"] + m["S"]).tocsr()
    got = mg.galerkin_chain_scipy(lhs, Us)
    ref = ref_mg.galerkin_chain_scipy(lhs, Us)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        scale = abs(b).max()
        assert abs(a - b).max() <= 1e-12 * scale
    A = ref[1]
    dinv = 1.0 / A.diagonal()
    assert mg.lambda_max_host(A, dinv) == ref_mg.lambda_max_host(A, dinv)
    for null_fix in (False, True):
        _assert_same(mg.coarse_inverse_host(ref[-1], null_fix),
                     ref_mg.coarse_inverse_host(ref[-1], null_fix))
    rhs = m["M"] @ np.random.default_rng(0).standard_normal((lhs.shape[0], 2))
    rs = np.asarray(lhs.sum(axis=1)).ravel()
    np.testing.assert_array_equal(mg.deflation_alpha(rs, rhs),
                                  ref_mg.deflation_alpha(rs, rhs))


def test_port_imports_and_solves_without_jax():
    """The port never imports JAX or gravo_mg_tpu, even transitively: a
    process where importing jax fails builds and solves a 642-vertex
    system (lower_bound=100, so cycles run) on the CPU."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["jax"] = None          # any `import jax` now raises
        sys.path.insert(0, {REPO!r})
        import numpy as np
        import gravo_mg_tpu_torch as gm
        from gravo_mg_tpu_torch.utils.meshgen import icosphere
        from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_voronoi
        from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces
        import gravo_mg_tpu_torch.convert, gravo_mg_tpu_torch.utils.io
        V, F = icosphere(3)
        S, M = cotan_laplacian(V, F), mass_voronoi(V, F)
        solver = gm.MultigridSolver(V, neighbors_from_faces(F), M,
                                    lower_bound=100, device="cpu")
        assert len(solver.hierarchy.dof) >= 2, solver.hierarchy.dof
        lhs = (M + 1e-3 * S).tocsr()
        x = solver.solve(lhs, M @ V)
        assert solver.solver_timing["iterations"] >= 1
        assert solver.residual(lhs, M @ V, x) <= 1e-4
        bad = [m for m, mod in sys.modules.items() if mod is not None and (
               m == "gravo_mg_tpu" or m.startswith("gravo_mg_tpu.")
               or m == "jax" or m.startswith("jax."))]
        assert not bad, bad
        print("OK", len(V))
    """)
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "OK 642" in res.stdout


def test_native_sources_are_the_ports_own_copies():
    """The native loader builds only from sources inside the port, and
    those are byte-identical to the JAX package's, so the two host halves
    cannot drift apart."""
    from gravo_mg_tpu_torch import native

    pkg = os.path.join(REPO, "gravo_mg_tpu_torch")
    assert [os.path.basename(s) for s in native.SOURCES] == [
        "gravomg_native.cpp", "ssp_native.cpp"]
    for src in native.SOURCES:
        src = os.path.realpath(src)
        assert os.path.commonpath([src, pkg]) == pkg, src
        with open(src, "rb") as f, open(os.path.join(
                REPO, "gravo_mg_tpu", "native", os.path.basename(src)), "rb") as g:
            assert f.read() == g.read(), src
