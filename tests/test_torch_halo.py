"""The port's halo-exchange solver (``gravo_mg_tpu_torch.parallel.halo``)
on the CPU, against its own single-device solve and the JAX package.

Counterparts of ``tests/test_halo.py`` on one process holding D
partitions (``make_solver_mesh(D, "cpu")``, the plain SpMVs), plus parity:

* ``_build_dist_op`` on the same csr gives the JAX package's arrays and
  exchange steps bit for bit;
* the port's ``HaloContext`` and the JAX one (8 virtual CPU devices) on
  the same hierarchy and rhs take the same cycles, and their f32
  solutions agree within 1e-4 relative;
* the stacked sliced apply (interior and compact halo part) equals the
  per-partition ShuffleEll applies of the reference's arrays.

Tolerances are written at each assert.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu.parallel import halo as ref_halo
from gravo_mg_tpu.parallel.dist import make_solver_mesh as ref_mesh
from gravo_mg_tpu_torch import MultigridSolver, convert
from gravo_mg_tpu_torch.parallel import halo
from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh
from gravo_mg_tpu_torch.solver import multigrid as mg
from gravo_mg_tpu_torch.sparse import ShuffleEll, spmv

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(request):
    m = request.getfixturevalue("medium_mesh")
    rhs = m["M"] @ np.random.default_rng(0).standard_normal(m["V"].shape[0])
    return m["V"], m["M"], m["S"], m["neigh"], rhs


def _context(setup, poisson=False):
    V, M, S, neigh, _ = setup
    lhs = ((1e-6 * M + S) if poisson else (M + 1e-3 * S)).tocsr()
    solver = MultigridSolver(V, neigh, M, lower_bound=200, device="cpu")
    return solver, lhs, solver._context(lhs)


def _mean_free_rel(x, ref):
    """max|x0 - ref0| / max|ref0| over the mean-free parts.  On a
    near-singular (deflated) system the constant that deflation adds back
    dominates max|x|, so only this difference sees the solved part."""
    x0, r0 = x - x.mean(axis=0), ref - ref.mean(axis=0)
    return np.abs(x0 - r0).max() / max(np.abs(r0).max(), 1e-30)


def test_halo_solve_matches_single_device(setup):
    rhs = setup[4]
    solver, lhs, ctx = _context(setup)
    x1, it1, _, _ = ctx.solve(rhs, tol=1e-5, max_iter=50)
    x2, it2, r2 = HaloContext(ctx, make_solver_mesh(8, "cpu")).solve(
        rhs, tol=1e-5, max_iter=50)
    assert r2 <= 1e-5
    assert abs(it1 - it2) <= 1          # same algorithm, same cycle counts
    scale = max(np.abs(x1).max(), 1e-30)
    assert np.abs(x1 - x2).max() / scale < 1e-4
    assert solver.residual(lhs, rhs, x2) <= 2e-5   # host f64


def test_halo_solve_near_singular_deflated(setup):
    """Poisson (eta M + S): the host f64 deflation and the coarse null
    projection run on the partitioned path; without them it stalls."""
    rhs = setup[4]
    _, _, ctx = _context(setup, poisson=True)
    x1, _, _, _ = ctx.solve(rhs, tol=1e-4, max_iter=50)
    x2, iters, res = HaloContext(ctx, make_solver_mesh(8, "cpu")).solve(
        rhs, tol=1e-4, max_iter=50)
    assert res <= 1e-4 and iters <= 20
    scale = max(np.abs(x1).max(), 1e-30)
    assert np.abs(x1 - x2).max() / scale < 1e-4
    assert _mean_free_rel(x2, x1) < 1e-4      # measured 1.3e-6 (f32)


def test_halo_exchange_only_needed_shifts(setup):
    """The plan keeps only ring shifts with traffic; on a locality-ordered
    torus only the two neighbouring shifts survive and the level-0 halo
    is a small fraction of the partition."""
    _, _, ctx = _context(setup)
    hctx = HaloContext(ctx, make_solver_mesh(8, "cpu"))
    for info in hctx.plan_info():
        for part in ("A", "U", "UT"):
            shifts = info[part]["shifts"]
            assert len(set(shifts)) == len(shifts)
            assert all(1 <= s <= 7 for s in shifts)
        assert info["A"]["halo"] < ctx.lhs_csr.shape[0]

    from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg_tpu_torch.utils.meshgen import torus_mesh
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

    V, F = torus_mesh(128, 64)
    M = mass_barycentric(V, F)
    lhs = (M + 1e-3 * cotan_laplacian(V, F)).tocsr()
    s = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=200,
                        device="cpu")
    t = HaloContext(s._context(lhs), make_solver_mesh(4, "cpu"))
    a0 = t.plan_info()[0]["A"]
    assert sorted(a0["shifts"]) == [1, 3]
    assert a0["halo"] < 0.1 * t.nloc[0]


@pytest.mark.parametrize("ndev", [2, 4])
def test_halo_solve_smaller_meshes(setup, ndev):
    rhs = setup[4]
    solver, lhs, ctx = _context(setup)
    x, _, res = HaloContext(ctx, make_solver_mesh(ndev, "cpu")).solve(rhs, tol=1e-4)
    assert res <= 1e-4
    assert solver.residual(lhs, rhs, x) <= 2e-4


def test_halo_after_update_lhs(setup):
    """update_lhs refreshes the host state the partitioner reads (chain,
    diagonals, spectral bounds, coarse inverse): a context updated to
    2 (M + 1e-3 S) is partitioned into a solver of the new system."""
    rhs = setup[4]
    solver, lhs, ctx = _context(setup)
    old_lam, old_inv = list(ctx.host_lam), ctx._host_coarse_inv[0]
    lhs2 = (2.0 * lhs).tocsr()
    ctx.update_lhs(lhs2)
    assert abs(ctx.chain_csr[0] - lhs2).max() == 0
    np.testing.assert_allclose(ctx.host_lam, old_lam, rtol=1e-12)  # D^-1 A unchanged
    np.testing.assert_allclose(ctx._host_coarse_inv[0], old_inv / 2, rtol=1e-9)
    x, _, res = HaloContext(ctx, make_solver_mesh(4, "cpu")).solve(rhs, tol=1e-5)
    assert res <= 1e-5 and solver.residual(lhs2, rhs, x) <= 2e-5


def test_halo_interior_split_exact(setup):
    """The interior/halo split of every level operator on the solve path
    (``PartitionedOp``'s stacked interior and compact halo part)
    reassembles the operator exactly (bit-level f32 values), and the
    interior part only sources its own partition's columns (the overlap
    contract)."""
    from gravo_mg_tpu_torch.ops.sliced_diag_spmv import sliced_diag_columns
    from gravo_mg_tpu_torch.ops.sliced_spmv import entry_rows
    from gravo_mg_tpu_torch.sparse import SlicedDiag

    _, _, ctx = _context(setup)
    D = 8
    hctx = HaloContext(ctx, make_solver_mesh(D, "cpu"))
    for k in range(ctx.cfg.num_levels):
        A_ref = ctx.chain_csr[k].tocsr()
        nl, P = hctx.nloc[k], hctx.stride[k]
        op = hctx.levels[k].A
        Ai = op.A
        rows = entry_rows(Ai.slice_ptr).numpy()
        if isinstance(Ai, SlicedDiag):
            cols = sliced_diag_columns(Ai.slice_ptr, Ai.base, Ai.delta, Ai.wide_ptr,
                                       Ai.wide_col).numpy()
        else:
            cols = Ai.col.long().numpy()
        vals = Ai.val.numpy()
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
        part = rows // P
        assert np.array_equal(cols // P, part)          # own partition only
        assert (rows % P).max() < nl and (cols % P).max() < nl
        rows_all = [part * nl + rows % P]
        cols_all = [part * nl + cols % P]
        vals_all = [vals]
        if op.Ah is not None:
            Ah, Hp = op.Ah, op.halo_pad
            hvals = Ah.val.numpy()
            keep = hvals != 0
            hrows = op.out_row.long().numpy()[entry_rows(Ah.slice_ptr).numpy()[keep]]
            hpos, hvals = Ah.col.long().numpy()[keep], hvals[keep]
            hcols = np.empty_like(hpos)
            for d in range(D):
                cg = A_ref[d * nl:(d + 1) * nl].tocoo().col
                hc = np.unique(cg[(cg < d * nl) | (cg >= (d + 1) * nl)])
                mine = hpos // Hp == d
                assert np.array_equal(hrows[mine] // P, np.full(mine.sum(), d))
                hcols[mine] = hc[hpos[mine] % Hp]
            rows_all.append(hrows // P * nl + hrows % P)
            cols_all.append(hcols)
            vals_all.append(hvals)
        got = sp.coo_matrix(
            (np.concatenate(vals_all),
             (np.concatenate(rows_all), np.concatenate(cols_all))),
            shape=(D * nl, D * nl),
        ).tocsr()[:A_ref.shape[0], :A_ref.shape[1]]
        diff = abs(got - A_ref.astype(np.float32))
        assert diff.nnz == 0 or diff.max() == 0.0


def test_halo_multi_rhs(setup):
    """(N, 3) right-hand sides through one loop; each column matches its
    own single-column solve."""
    V, M = setup[0], setup[1]
    solver, lhs, ctx = _context(setup)
    hctx = HaloContext(ctx, make_solver_mesh(8, "cpu"))
    B = M @ V
    X, _, res = hctx.solve(B, tol=1e-5, max_iter=50)
    assert X.shape == B.shape and res <= 1e-5
    for col in range(3):
        xc, _, _ = hctx.solve(B[:, col], tol=1e-5, max_iter=50)
        scale = max(np.abs(xc).max(), 1e-30)
        assert np.abs(X[:, col] - xc).max() / scale < 2e-4
    assert solver.residual(lhs, B, X) <= 2e-5


# ---- parity with the JAX package -------------------------------------------


@pytest.fixture(scope="module")
def ref_pair(setup):
    """A JAX solver on the medium mesh and its smoothing lhs (M + 1e-3 S)."""
    V, M, S, neigh, _ = setup
    lhs = (M + 1e-3 * S).tocsr()
    ref = RefSolver(V, neigh, M, lower_bound=200)
    return ref, lhs


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("which", ["A0", "U0T", "M"])
def test_build_dist_op_matches_reference(ref_pair, which, D):
    """Same csr in, identical q/r/v/qh/rh/vh and exchange steps out (the
    reference's plan read through ``convert.dist_op_from_reference``); the
    partitioned apply of that plan equals the global product (f64, 1e-12
    of max|y|)."""
    ref, lhs = ref_pair
    ctx = ref._context(lhs)
    nl0 = -(-ctx.chain_csr[0].shape[0] // (128 * D)) * 128
    nl1 = -(-ctx.chain_csr[1].shape[0] // (128 * D)) * 128
    A, rl, cl = {
        "A0": (ctx.chain_csr[0], nl0, nl0),
        "U0T": (ctx.U_csr[0].T.tocsr(), nl1, nl0),
        "M": (ctx.mass_csr, nl0, nl0),
    }[which]
    want = convert.dist_op_from_reference(
        ref_halo._build_dist_op(A, D, rl, cl, np.float32))
    got = halo._build_dist_op(A, D, rl, cl, torch.float32)
    for f in ("q", "r", "v", "qh", "rh", "vh"):
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert np.array_equal(a, b), f
    for f in ("rows_local", "cols_local", "halo", "halo_pad"):
        assert getattr(got, f) == getattr(want, f), f
    assert [s for s, _, _ in got.steps] == [s for s, _, _ in want.steps]
    for (_, si, rp), (_, si2, rp2) in zip(got.steps, want.steps):
        assert np.array_equal(si, si2) and np.array_equal(rp, rp2)

    # The port's sliced apply (built from the csr and its plan) against the
    # global product and the per-partition ShuffleEll applies of the
    # reference's f64 arrays.
    ref64 = convert.dist_op_from_reference(
        ref_halo._build_dist_op(A, D, rl, cl, np.float64))
    p_in, p_out = -(-cl // 1024) * 1024, -(-rl // 1024) * 1024
    op = halo.PartitionedOp(A, halo._halo_plan(A, D, rl, cl),
                            make_solver_mesh(D, "cpu"), p_in, p_out, torch.float64)
    x = np.random.default_rng(1).standard_normal(A.shape[1])
    xg = np.pad(x, (0, D * cl - x.size))
    xl = np.zeros((D, p_in))
    xl[:, :cl] = xg.reshape(D, cl)
    y = op(torch.from_numpy(xl.reshape(-1))).numpy().reshape(D, p_out)
    y_glob = A @ x
    scale = np.abs(y_glob).max()
    assert np.abs(y[:, :rl].reshape(-1)[: A.shape[0]] - y_glob).max() <= 1e-12 * scale
    for g in range(D):
        yi = _shuffle_partition(ref64, A, g, xg[:, None], p_out)[:, 0]
        assert np.abs(y[g] - yi).max() <= 1e-12 * scale


@pytest.mark.parametrize("poisson", [False, True])
def test_halo_context_matches_reference(setup, poisson):
    """The JAX HaloContext on 8 devices and the port's on 8 partitions,
    same hierarchy and rhs: equal cycles, f32 solutions within 1e-4 of
    max|x| (summation order differs)."""
    V, M, S, neigh, rhs = setup
    lhs = ((1e-6 * M + S) if poisson else (M + 1e-3 * S)).tocsr()
    ref = RefSolver(V, neigh, M, lower_bound=200)
    x_ref, it_ref, res_ref = ref_halo.HaloContext(
        ref._context(lhs), ref_mesh(8)).solve(rhs, tol=1e-5, max_iter=50)
    ctx = mg.MultigridSolveContext(
        convert.hierarchy_from_reference(ref.hierarchy), lhs, M,
        mg.SolverConfig(), device="cpu")
    x, it, res = HaloContext(ctx, make_solver_mesh(8, "cpu")).solve(
        rhs, tol=1e-5, max_iter=50)
    assert it == it_ref, (it, it_ref)
    assert res <= 1e-5 or it == 50
    assert abs(res - res_ref) <= 0.05 * res_ref     # same trace, f32 rounding
    assert np.abs(x - x_ref).max() / np.abs(x_ref).max() < 1e-4
    assert _mean_free_rel(x, x_ref) < 1e-4    # measured 1.1e-6 on Poisson (f32)


def _shuffle_partition(op, A, g, xg, p_out):
    """Partition g's interior + halo apply of a DistOp's ShuffleEll arrays
    (the reference's layout) on the global ``xg (D * cl, d)``: its
    ``(p_out, d)`` output rows."""
    rl, cl = op.rows_local, op.cols_local
    Ai = ShuffleEll(torch.from_numpy(op.q[g]), torch.from_numpy(op.r[g]),
                    torch.from_numpy(op.v[g]), p_out, cl)
    yi = spmv(Ai, torch.from_numpy(xg[g * cl:(g + 1) * cl].copy())).numpy()
    if op.halo:
        cols = A[g * rl:(g + 1) * rl].tocoo().col
        hc = np.unique(cols[(cols < g * cl) | (cols >= (g + 1) * cl)])
        hb = np.zeros((op.halo_pad, xg.shape[1]))
        hb[: len(hc)] = xg[hc]
        Ah = ShuffleEll(torch.from_numpy(op.qh[g]), torch.from_numpy(op.rh[g]),
                        torch.from_numpy(op.vh[g]), p_out, op.halo_pad)
        yi = yi + spmv(Ah, torch.from_numpy(hb)).numpy()
    return yi


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("which", ["A0", "U0T"])
def test_stacked_apply_equals_per_partition(setup, which, d):
    """The stacked apply (one interior and one halo launch for all
    partitions) gives each partition's own interior + halo apply of the
    reference layout, and the global product: f64, within 1e-12 of
    max|y|."""
    _, _, ctx = _context(setup)
    D = 4
    mesh = make_solver_mesh(D, "cpu")
    n0, n1 = ctx.chain_csr[0].shape[0], ctx.chain_csr[1].shape[0]
    nl0 = -(-n0 // (128 * D)) * 128
    nl1 = -(-n1 // (128 * D)) * 128
    P0, P1 = -(-nl0 // 1024) * 1024, -(-nl1 // 1024) * 1024
    A, rl, cl, p_out, p_in = {
        "A0": (ctx.chain_csr[0], nl0, nl0, P0, P0),
        "U0T": (ctx.U_csr[0].T.tocsr(), nl1, nl0, P1, P0),
    }[which]
    op = halo._build_dist_op(A, D, rl, cl, np.float64)
    stacked = halo.PartitionedOp(A, halo._halo_plan(A, D, rl, cl), mesh, p_in,
                                 p_out, torch.float64)
    rng = np.random.default_rng(5)
    xg = np.zeros((D * cl, d))
    xg[: A.shape[1]] = rng.standard_normal((A.shape[1], d))
    x_loc = np.zeros((D, p_in, d))
    x_loc[:, :cl] = xg.reshape(D, cl, d)
    y = stacked(torch.from_numpy(x_loc.reshape(D * p_in, d))).numpy()
    y = y.reshape(D, p_out, d)
    y_glob = A @ xg[: A.shape[1]]
    scale = np.abs(y_glob).max()
    for g in range(D):
        yi = _shuffle_partition(op, A, g, xg, p_out)
        assert np.abs(y[g] - yi).max() <= 1e-12 * scale
        nr = max(min(rl, A.shape[0] - g * rl), 0)   # real rows of partition g
        assert np.abs(y[g, :nr] - y_glob[g * rl:g * rl + nr]).max(initial=0) <= 1e-12 * scale
        assert not y[g, nr:].any()               # padded rows stay zero
