"""The SlicedDiag layout and its plain SpMV against the JAX package.

* ``sliced_diag_spmv_plain`` on the port's SlicedDiag of a matrix equals
  the JAX package's ``diag_spmv`` on its own DiagEll of the same matrix
  (the XLA path), and a scipy product, for d = 1 and 3, in f32 and f64;
  once more against the Pallas diagonal-run kernel itself in TPU interpret
  mode.  Matrices: numpy-seeded banded ones (duplicates summed), a small
  torus whose wrap-around rows give wide slices, a randomly permuted one
  (every slice wide), fewer rows than one slice, and empty rows.
  Tolerance 1e-5 (f32) / 1e-12 (f64) of max|y|: the layouts sum a row's
  entries in different orders.
* Layout invariants: every nonzero placed once, in CSR column order; the
  columns it rebuilds equal CSR's; padding has weight 0 and an in-range
  column; a slice is wide exactly when a slot's int8 deltas cannot hold
  its real offsets or its padding; the runs of ``sliced_pattern`` are
  ``sliced_diag_from_scipy``'s.
* The planner: SlicedDiag for a torus finest level, SlicedEll for a
  permuted one; every level, a dense row's too, the layout of
  ``sliced_layout_from_scipy``; ``update_lhs`` equals a fresh context.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu import sparse as ref_sparse
from gravo_mg_tpu.ops.diag_spmv import _diag_spmv_pallas
from gravo_mg_tpu_torch import MultigridSolver, sparse
from gravo_mg_tpu_torch.ops import sliced_diag_spmv as sdmod
from gravo_mg_tpu_torch.solver import multigrid as mg
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_barycentric
from gravo_mg_tpu_torch.utils.meshgen import torus_mesh
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

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


def _torus_laplacian(nu, nv):
    V, F = torus_mesh(nu, nv)
    return (1e-6 * mass_barycentric(V, F) + cotan_laplacian(V, F)).tocsr()


def _matrix(kind):
    """A scipy csr matrix (duplicates summed) of the named shape."""
    if kind == "torus":              # v-wrap offsets of 299: wide slices
        return _torus_laplacian(12, 300)
    if kind == "permuted":           # a banded matrix, rows and columns shuffled
        A = _matrix("banded_30")
        p = np.random.default_rng(9).permutation(A.shape[0])
        A = A[p][:, p].tocsr()
        A.sort_indices()
        return A
    n, m, nnz, bw, seed = {
        "banded_30": (1000, 1000, 7000, 30, 0),
        "banded_100": (3000, 3000, 20000, 100, 1),
        "banded_400": (5000, 5000, 45000, 400, 2),    # most slots spread > 255
        "under_one_slice": (20, 20, 90, None, 5),
        "empty_rows": (500, 500, 300, None, 7),       # most rows empty
    }[kind]
    rows, cols, vals = _coo(n, m, nnz, bw, seed)
    if kind == "empty_rows":
        keep = rows % 3 != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        rows = np.where(rows >= 64, rows, rows % 32)    # rows 32..63 empty
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()
    A.sum_duplicates()
    return A


KINDS = ["banded_30", "banded_100", "banded_400", "torus", "permuted",
         "under_one_slice", "empty_rows"]


def _x(m, d, dtype, seed=0):
    rng = np.random.default_rng(seed + 100)
    return rng.standard_normal((m,) if d == 1 else (m, d)).astype(dtype)


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    atol = RTOL[dtype] * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=atol)


def _plain(op, x):
    return sdmod.sliced_diag_spmv_plain(op.slice_ptr, op.base, op.delta, op.val,
                                        op.wide_ptr, op.wide_col, x, op.nrows)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_sliced_diag_plain_matches_reference_diag(kind, dtype, d):
    A = _matrix(kind)
    n, m = A.shape
    x = _x(m, d, dtype)
    ref_op = ref_sparse.diag_from_scipy(A, dtype=jnp.dtype(dtype))
    ref = np.asarray(ref_sparse.spmv(ref_op, jnp.asarray(x)))   # the XLA path
    op = sparse.sliced_diag_from_scipy(A, dtype=TORCH[dtype])
    got = _plain(op, torch.from_numpy(x))
    assert got.dtype == TORCH[dtype] and got.shape == ref.shape
    _close(got, ref, dtype)
    _close(got, A @ x.astype(np.float64), dtype)
    # the wrapper on a CPU tensor is the plain version, through spmv
    _close(sparse.spmv(op, torch.from_numpy(x)), ref, dtype)


def test_sliced_diag_plain_matches_reference_pallas_interpret():
    """Against the Pallas diagonal-run kernel in TPU interpret mode at its
    production tile (tg = 512, one full tile of 512 groups), f32, d = 1."""
    from jax.experimental.pallas import tpu as pltpu

    tg = 512
    n = tg * 128
    rows, cols, vals = _coo(n, n, 3 * n, 100, 7)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    kp, s_pad, _, start, pos = ref_sparse._diag_layout(
        np.asarray(A.row, np.int64), np.asarray(A.col, np.int64), n, n, tg=tg)
    r = np.zeros((kp * s_pad * 128,), np.int8)
    v = np.zeros((kp * s_pad * 128,), np.float32)
    r[pos] = (np.asarray(A.col) & 127).astype(np.int8)
    v[pos] = A.data
    x = _x(n, 1, np.float32, 7)
    xp = np.zeros(((n // 128 + 2 * tg) * 128,), np.float32)
    xp[tg * 128: tg * 128 + n] = x
    with pltpu.force_tpu_interpret_mode():
        ref = _diag_spmv_pallas(jnp.asarray(start), jnp.asarray(xp.reshape(-1, 128)),
                                jnp.asarray(r.reshape(kp, s_pad, 128)),
                                jnp.asarray(v.reshape(kp, s_pad, 128)), tg)
    A = A.tocsr()
    op = sparse.sliced_diag_from_scipy(A, dtype=torch.float32)
    assert op.info()["wide_slices"] < op.info()["slices"] // 2
    _close(_plain(op, torch.from_numpy(x)), np.asarray(ref).reshape(-1)[:n],
           np.float32)


def _spread_or_padding_fails(ptr, col, real, ncols):
    """Per slice, by loops: does a slot fail the int8 test?  A slot's base
    is the middle of its real offsets' range (col - row); it fails where
    the range spans more than 255, or where a padding lane's column row +
    base, moved into [0, ncols), lies more than 128 off."""
    fails = np.zeros(ptr.size - 1, bool)
    for s in range(ptr.size - 1):
        for e0 in range(ptr[s], ptr[s + 1], 32):
            rows = 32 * s + np.arange(32)
            re = real[e0:e0 + 32]
            off = col[e0:e0 + 32].astype(np.int64) - rows
            lo, hi = off[re].min(), off[re].max()
            base = lo + (hi - lo + 1) // 2
            pad = np.clip(rows + base, 0, ncols - 1) - rows - base
            if hi - lo > 255 or (~re & ((pad < -128) | (pad > 127))).any():
                fails[s] = True
    return fails


@pytest.mark.parametrize("kind", KINDS)
def test_sliced_diag_layout_invariants(kind):
    A = _matrix(kind)
    n, m = A.shape
    op = sparse.sliced_diag_from_scipy(A, dtype=torch.float64)
    ell = sparse.sliced_from_scipy(A, dtype=torch.float64)
    ptr = op.slice_ptr.numpy()
    assert np.array_equal(ptr, ell.slice_ptr.numpy())     # SlicedEll's slices
    assert op.delta.numel() == op.val.numel() == 32 * op.base.numel() == ptr[-1]
    col = sdmod.sliced_diag_columns(op.slice_ptr, op.base, op.delta, op.wide_ptr,
                                    op.wide_col).numpy()
    val = op.val.numpy()
    assert col.min(initial=0) >= 0 and col.max(initial=0) < m
    # the real entries, each placed once, in CSR order, with CSR's columns
    deg = np.zeros(ptr.size * 32, np.int64)
    deg[:n] = np.diff(A.indptr)
    rows = sdmod.entry_rows(op.slice_ptr).numpy()
    slot = (np.arange(col.size) - ptr[rows // 32]) // 32
    real = slot < deg[rows]
    assert not val[~real].any()
    order = np.lexsort((slot[real], rows[real]))
    assert np.array_equal(col[real][order], A.indices)
    assert np.array_equal(val[real][order], A.data)
    assert np.array_equal(col[real], ell.col.numpy()[real])
    assert op.nnz == A.nnz == real.sum()
    # wide exactly where a slot fails the int8 test; their columns verbatim
    wide_ptr = op.wide_ptr.numpy()
    wide = wide_ptr >= 0
    assert np.array_equal(wide, _spread_or_padding_fails(ptr, col, real, m))
    widths = np.diff(ptr) // 32
    assert op.wide_col.numel() == 32 * widths[wide].sum()
    for s in np.flatnonzero(wide):
        w = op.wide_col.numpy()[wide_ptr[s]:wide_ptr[s] + ptr[s + 1] - ptr[s]]
        assert np.array_equal(w, ell.col.numpy()[ptr[s]:ptr[s + 1]])
    slot_wide = np.repeat(wide, widths)
    assert not op.base.numpy()[slot_wide].any()
    assert not op.delta.numpy().reshape(-1, 32)[slot_wide].any()
    info = op.info()
    assert info["wide_slices"] == wide.sum() and info["slices"] == wide.size
    assert info["entries"] == ptr[-1] and info["max_width"] == op.wmax
    assert info["bytes"] == (sparse.sliced_diag_bytes(ptr, wide_ptr, 8)
                             + 8 * (n + m))
    if kind == "torus":
        assert 0 < wide.sum() < wide.size // 2
    if kind == "permuted":
        assert wide.all()


@pytest.mark.parametrize("kind", ["banded_30", "torus", "empty_rows"])
def test_sliced_pattern_gives_the_sliced_diag_runs(kind):
    A = _matrix(kind)                # square, as the planner's levels are
    ptr, col, pos = sparse.sliced_pattern(A)
    op = sparse.sliced_diag_from_scipy(A, dtype=torch.float64)
    runs = sparse.sliced_diag_arrays(ptr, col, pos != A.nnz, A.shape[1])
    for got, want in ((ptr, op.slice_ptr), (runs[0], op.base), (runs[1], op.delta),
                      (runs[2], op.wide_ptr), (runs[3], op.wide_col)):
        assert np.array_equal(got, want.numpy())
    assert np.array_equal(np.append(A.data, 0.0)[pos], op.val.numpy())


@pytest.mark.parametrize("kind,want", [("torus", sparse.SlicedDiag),
                                       ("permuted", sparse.SlicedEll),
                                       ("banded_400", sparse.SlicedEll)])
def test_byte_rule_picks_the_smaller_layout(kind, want):
    A = _matrix(kind)
    op = sparse.sliced_layout_from_scipy(A)
    assert type(op) is want
    ptr = sparse.sliced_from_scipy(A).slice_ptr.numpy()
    diag = sparse.sliced_diag_from_scipy(A)
    smaller = (sparse.sliced_diag_bytes(ptr, diag.wide_ptr.numpy(), 4)
               < sparse.sliced_bytes(ptr, 4))
    assert smaller == (want is sparse.SlicedDiag)


def _torus_solver(permute):
    V, F = torus_mesh(64, 64)
    if permute:                      # the same mesh, vertices shuffled
        p = np.random.default_rng(4).permutation(len(V))
        inv = np.argsort(p)
        V, F = V[p], inv[F].astype(F.dtype)
    S, M = cotan_laplacian(V, F), mass_barycentric(V, F)
    solver = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=300,
                             device="cpu", diag_min_groups=32)
    return solver, S, M


@pytest.mark.parametrize("permute,want", [(False, sparse.SlicedDiag),
                                          (True, sparse.SlicedEll)])
def test_planner_picks_sliced_diag_for_a_torus_finest_level(permute, want):
    solver, S, M = _torus_solver(permute)
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ np.random.default_rng(0).standard_normal(lhs.shape[0])
    sdmod.launches = 0
    x = solver.solve(lhs, rhs)
    assert solver.residual(lhs, rhs, x) <= 1e-4
    ctx = next(iter(solver._contexts.values()))
    assert type(ctx.levels[0].A) is want          # 32 row groups pass the gate
    assert all(type(lvl.A) is sparse.SlicedEll for lvl in ctx.levels[1:])
    assert sdmod.launches == 0                    # CPU tensors: the plain version


def _assert_same_layout(got, want):
    assert type(got) is type(want)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert torch.equal(a, b) if torch.is_tensor(b) else a == b, f.name


def test_planner_builds_the_layout_of_sliced_layout_from_scipy():
    """The planner's level-0 SlicedDiag is the one
    :func:`sparse.sliced_layout_from_scipy` builds from the chain's level,
    in every array and in its values."""
    solver, S, M = _torus_solver(False)
    ctx = solver._context((1e-6 * M + S).tocsr())
    assert isinstance(ctx.levels[0].A, sparse.SlicedDiag)
    _assert_same_layout(ctx.levels[0].A, sparse.sliced_layout_from_scipy(
        ctx.chain_csr[0], dtype=ctx.dtype, min_groups=32))


def test_planner_lays_out_a_dense_row_sliced():
    """A level with a dense row (and column) stays SlicedEll or SlicedDiag
    on every level, each equal to :func:`sparse.sliced_layout_from_scipy`
    of its chain level."""
    solver, S, M = _torus_solver(False)
    n = S.shape[0]
    # W^T W couples vertex 0 to every vertex: a dense row and column, SPD
    W = sp.csr_matrix((np.full(2 * (n - 1), 1e-2),
                       (np.repeat(np.arange(n - 1), 2),
                        np.stack([np.zeros(n - 1, int), np.arange(1, n)], 1).ravel())),
                      shape=(n - 1, n))
    lhs = (1e-6 * M + S + W.T @ W).tocsr()
    ctx = solver._context(lhs)
    assert np.diff(ctx.chain_csr[0].indptr).max() == n
    for k, level in enumerate(ctx.levels):
        assert type(level.A) in (sparse.SlicedEll, sparse.SlicedDiag)
        _assert_same_layout(level.A, sparse.sliced_layout_from_scipy(
            ctx.chain_csr[k], dtype=ctx.dtype, min_groups=ctx.diag_min_groups))


def test_update_lhs_on_a_sliced_diag_level_equals_fresh_context():
    solver, S, M = _torus_solver(False)
    lhs = (M + 1e-3 * S).tocsr()
    ctx = solver._context(lhs)
    assert isinstance(ctx.levels[0].A, sparse.SlicedDiag)
    lhs2 = (1e-6 * M + S).tocsr()
    fresh = mg.MultigridSolveContext(ctx.hierarchy, lhs2, M, mg.SolverConfig(),
                                     device="cpu", diag_min_groups=32)
    ctx.update_lhs(lhs2)
    for a, b in zip(ctx.levels, fresh.levels):
        assert type(a.A) is type(b.A)
        for f in ("slice_ptr", "val", "base", "delta", "wide_ptr", "wide_col", "col"):
            if hasattr(a.A, f):
                assert torch.equal(getattr(a.A, f), getattr(b.A, f)), f
        assert torch.equal(a.diag_inv, b.diag_inv) and a.lam_max == b.lam_max
    rhs = M @ np.random.default_rng(5).standard_normal(lhs2.shape[0])
    x1, it1, _, _ = ctx.solve(rhs, tol=1e-6)
    x2, it2, _, _ = fresh.solve(rhs, tol=1e-6)
    assert it1 == it2 and np.array_equal(x1, x2)


def test_wrapper_refuses_non_cpu_devices_without_fallback():
    """The plain version only for CPU tensors; anything else goes to the
    kernel path, which validates and never falls back."""
    op = sparse.sliced_diag_from_scipy(_matrix("banded_30"))
    x = torch.zeros(op.ncols, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sparse.spmv(op, x)
