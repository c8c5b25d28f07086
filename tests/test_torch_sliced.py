"""The SlicedEll layout and its plain SpMV against the JAX package.

* ``sliced_spmv_plain`` on the port's SlicedEll of a matrix equals the
  JAX package's ``shuffle_spmv`` on its own ShuffleEll of the same matrix
  (numpy-seeded COO triplets with duplicates, summed), for d = 1 and 3, in
  f32 and f64; once more against the Pallas lane-shuffle kernel itself in
  TPU interpret mode.  Tolerance 1e-5 (f32) / 1e-12 (f64) of max|y|: the
  two layouts sum a row's entries in different orders.
* Layout invariants: each nonzero placed once, padding weight 0 with an
  in-range column, ``w_s`` the slice's largest degree, CSR column order
  within a row; ``sliced_pattern`` maps each entry to its csr position.
* The solve context: SlicedEll levels, transfers and mass matrix;
  ``update_lhs`` equals a fresh context.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu import sparse as ref_sparse
from gravo_mg_tpu.hierarchy.builder import build_hierarchy as ref_build
from gravo_mg_tpu_torch import convert, sparse
from gravo_mg_tpu_torch.ops import sliced_spmv as slmod
from gravo_mg_tpu_torch.solver import multigrid as mg

torch.set_num_threads(2)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _coo(n, m, nnz, bw, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    if bw is None:
        cols = rng.integers(0, m, nnz)
    else:
        cols = np.clip(rows * m // n + rng.integers(-bw, bw + 1, nnz), 0, m - 1)
    rows = np.concatenate([rows, rows[: nnz // 8]])   # duplicates
    cols = np.concatenate([cols, cols[: nnz // 8]])
    return rows, cols, rng.standard_normal(rows.size)


def _matrix(kind):
    """A scipy csr matrix (duplicates summed) of the named shape."""
    if kind == "dense_row":
        n = 700
        rows, cols, vals = _coo(n, n, 2800, 3, 6)
        A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tolil()
        A[37, :] = np.random.default_rng(6).standard_normal(n)
        return A.tocsr()
    n, m, nnz, bw, seed = {
        "banded": (1000, 1000, 7000, 30, 0),
        "random": (3000, 3000, 6000, None, 2),
        "restriction": (2000, 300, 8000, 20, 3),
        "prolongation": (300, 2000, 2400, 40, 4),
        "under_one_slice": (20, 45, 90, None, 5),
        "empty_rows": (500, 500, 300, None, 7),    # most rows empty
    }[kind]
    rows, cols, vals = _coo(n, m, nnz, bw, seed)
    if kind == "empty_rows":
        keep = rows % 3 != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        rows = np.where(rows >= 64, rows, rows % 32)    # rows 32..63 empty
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()
    A.sum_duplicates()
    return A


KINDS = ["banded", "random", "restriction", "prolongation",
         "under_one_slice", "empty_rows", "dense_row"]


def _x(m, d, dtype, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.standard_normal((m,) if d == 1 else (m, d)).astype(dtype)


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    atol = RTOL[dtype] * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_sliced_plain_matches_reference_shuffle(kind, dtype, d):
    A = _matrix(kind)
    n, m = A.shape
    x = _x(m, d, dtype)
    ref_op = ref_sparse.shuffle_from_scipy(A, dtype=jnp.dtype(dtype))
    ref = np.asarray(ref_sparse.shuffle_spmv(ref_op, jnp.asarray(x)))
    op = sparse.sliced_from_scipy(A, dtype=TORCH[dtype])
    got = slmod.sliced_spmv_plain(op.slice_ptr, op.col, op.val,
                                  torch.from_numpy(x), n)
    assert got.dtype == TORCH[dtype] and got.shape == ref.shape
    _close(got, ref, dtype)
    # the wrapper on a CPU tensor is the plain version, through spmv
    _close(sparse.spmv(op, torch.from_numpy(x)), ref, dtype)


def test_sliced_plain_matches_reference_pallas_interpret(monkeypatch):
    """Against the Pallas lane-shuffle kernel in TPU interpret mode (the
    row gather as ``shuffle_spmv_1d`` does it), f32, d = 1."""
    from jax.experimental.pallas import tpu as pltpu

    from gravo_mg_tpu.ops import shuffle_spmv as ref_ops

    A = _matrix("restriction").astype(np.float32)
    n, m = A.shape
    x = _x(m, 1, np.float32)
    op = ref_sparse.shuffle_from_scipy(A, dtype=jnp.float32)
    kp, s = op.q.shape
    xb = np.zeros((-(-m // 128) * 128,), np.float32)
    xb[:m] = x
    z = jnp.take(jnp.asarray(xb.reshape(-1, 128)), op.q.reshape(-1),
                 axis=0).reshape(kp, s, 128)
    monkeypatch.setattr(ref_ops, "_use_pallas", lambda: True)
    with pltpu.force_tpu_interpret_mode():
        ref = ref_ops.lane_shuffle_fma.__wrapped__(z, op.r, op.v)
    ref = np.asarray(ref).reshape(-1)[:n]
    got = sparse.sliced_from_scipy(A, dtype=torch.float32)
    _close(sparse.spmv(got, torch.from_numpy(x)), ref, np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_sliced_layout_invariants(kind):
    A = _matrix(kind)
    n, m = A.shape
    op = sparse.sliced_from_scipy(A, dtype=torch.float64)
    ptr, col, val = op.slice_ptr.numpy(), op.col.numpy(), op.val.numpy()
    n_slices = -(-n // 32)
    assert ptr.shape == (n_slices + 1,) and ptr[0] == 0 and ptr[-1] == col.size
    widths = np.diff(ptr) // 32
    assert np.array_equal(np.diff(ptr), 32 * widths)
    deg = np.zeros(n_slices * 32, np.int64)
    deg[:n] = np.diff(A.indptr)
    assert np.array_equal(widths, deg.reshape(n_slices, 32).max(axis=1))
    assert col.min(initial=0) >= 0 and col.max(initial=0) < m
    # entry (s, k, lane) of row 32 s + lane; real entries are the first
    # deg slots, in CSR column order; the rest is padding of weight 0
    rows = slmod.entry_rows(op.slice_ptr).numpy()
    slot = (np.arange(col.size) - ptr[rows // 32]) // 32
    real = slot < deg[rows]
    assert not val[~real].any() and not col[~real].any()
    order = np.lexsort((slot[real], rows[real]))
    assert np.array_equal(col[real][order], A.indices)
    assert np.array_equal(val[real][order], A.data)
    assert op.nnz == A.nnz == real.sum()
    info = op.info()
    assert info["entries"] == col.size and info["slices"] == n_slices
    assert info["threads_per_row"] == sparse.pick_tpr(ptr, n)


@pytest.mark.parametrize("kind", ["banded", "empty_rows", "dense_row"])
def test_sliced_pattern_maps_each_entry_to_its_csr_position(kind):
    A = _matrix(kind)            # square, as the planner's levels are
    ptr, col, pos = sparse.sliced_pattern(A)
    op = sparse.sliced_from_scipy(A, dtype=torch.float64)
    assert np.array_equal(ptr, op.slice_ptr.numpy())
    assert np.array_equal(col, op.col.numpy())
    assert np.array_equal(np.append(A.data, 0.0)[pos], op.val.numpy())
    # each csr position once, in its own row; padding is nnz, column 0
    assert pos.dtype == np.int32
    real = pos != A.nnz
    assert np.array_equal(np.sort(pos[real]), np.arange(A.nnz))
    assert not col[~real].any() and (~real).sum() == col.size - A.nnz
    rows = slmod.entry_rows(op.slice_ptr).numpy()[real]
    assert np.array_equal(np.searchsorted(A.indptr, pos[real], side="right") - 1,
                          rows)
    assert np.array_equal(A.indices[pos[real]], col[real])


@pytest.mark.parametrize("nrows,wmax,tpr", [
    (1 << 20, 3, 1), (129959, 22, 1), (129959, 38, 2), (65522, 67, 4),
    (16911, 31, 4), (2157, 28, 32),
    (282, 39, 32), (16911, 3, 4), (300, 1, 1), (300, 0, 1),
])
def test_pick_tpr(nrows, wmax, tpr):
    slices = -(-nrows // 32)
    widths = np.full(slices, wmax, np.int64)
    ptr = np.concatenate([[0], np.cumsum(32 * widths)])
    assert sparse.pick_tpr(ptr, nrows) == tpr


@pytest.fixture(scope="module")
def context(sphere_mesh):
    m = sphere_mesh
    hier = convert.hierarchy_from_reference(
        ref_build(m["V"], m["neigh"], lower_bound=100))
    lhs = (m["M"] + 1e-3 * m["S"]).tocsr()
    ctx = mg.MultigridSolveContext(hier, lhs, m["M"], mg.SolverConfig(),
                                   device="cpu")
    return hier, ctx


def test_context_plans_sliced_everywhere(context, sphere_mesh):
    hier, ctx = context
    assert all(isinstance(lvl.A, sparse.SlicedEll) for lvl in ctx.levels)
    assert all(isinstance(t.U, sparse.SlicedEll)
               and isinstance(t.UT, sparse.SlicedEll) for t in ctx.transfers)
    assert isinstance(ctx.M, sparse.SlicedEll)
    x = _x(ctx.M.ncols, 2, np.float32)
    _close(sparse.spmv(ctx.M, torch.from_numpy(x)),
           sphere_mesh["M"] @ x.astype(np.float64), np.float32)
    for k, lvl in enumerate(ctx.levels):
        A = ctx.chain_csr[k]
        x = _x(A.shape[1], 1, np.float32, k)
        _close(sparse.spmv(lvl.A, torch.from_numpy(x)), A @ x, np.float32)
        x = _x(ctx.U_csr[k].shape[1], 1, np.float32, k)
        _close(ctx.transfers[k].prolong(torch.from_numpy(x)),
               ctx.U_csr[k] @ x, np.float32)


def test_update_lhs_on_sliced_levels_equals_fresh_context(context, sphere_mesh):
    hier, ctx = context
    m = sphere_mesh
    lhs2 = (1e-6 * m["M"] + m["S"]).tocsr()
    fresh = mg.MultigridSolveContext(hier, lhs2, m["M"], mg.SolverConfig(),
                                     device="cpu")
    ctx.update_lhs(lhs2)
    for a, b in zip(ctx.levels, fresh.levels):
        assert isinstance(a.A, sparse.SlicedEll) and a.A.tpr == b.A.tpr
        for f in ("slice_ptr", "col", "val"):
            assert torch.equal(getattr(a.A, f), getattr(b.A, f)), f
        assert torch.equal(a.diag_inv, b.diag_inv) and a.lam_max == b.lam_max
    rhs = m["M"] @ np.random.default_rng(5).standard_normal(lhs2.shape[0])
    x1, it1, _, _ = ctx.solve(rhs, tol=1e-6)
    x2, it2, _, _ = fresh.solve(rhs, tol=1e-6)
    assert it1 == it2 and np.array_equal(x1, x2)
