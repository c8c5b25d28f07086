"""The halo path's layouts (``parallel/halo.py::PartitionedOp``) and the
plain version of its halo kernel (``ops/halo_spmv.py``), on the CPU.

* ``halo_spmv_plain`` equals a dense scatter-add on random compact
  layouts (an empty part, d = 1 and 3, f32 and f64);
* the stacked interior of a level operator takes the planner's rule
  (SlicedDiag at the solver's default gate where it streams fewer bytes,
  SlicedEll with the gate raised above its group count); transfers and
  the mass matrix are SlicedEll;
* the halo part holds exactly the rows with an off-partition column, at
  most 32 stored entries per nonzero, and the interior only sources its
  own partition's columns;
* the halo buffer kept across applies leaks nothing from one apply into
  the next.

Inputs come from numpy seeds; tolerances are written at each assert.
"""

import inspect

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu_torch import MultigridSolver, sparse
from gravo_mg_tpu_torch.ops.halo_spmv import halo_spmv, halo_spmv_plain
from gravo_mg_tpu_torch.ops.sliced_spmv import entry_rows
from gravo_mg_tpu_torch.parallel import halo
from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh
from gravo_mg_tpu_torch.solver import multigrid as mg

torch.set_num_threads(2)


def _torus_lhs(nu, nv):
    from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg_tpu_torch.utils.meshgen import torus_mesh
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

    V, F = torus_mesh(nu, nv)
    M = mass_barycentric(V, F)
    return V, M, neighbors_from_faces(F), (M + 1e-3 * cotan_laplacian(V, F)).tocsr()


def _local(xg, D, nl, P):
    """Global rows (n, d) -> the stacked local vector (D * P, d)."""
    d = xg.shape[1]
    full = np.zeros((D * nl, d))
    full[: xg.shape[0]] = xg
    xl = np.zeros((D, P, d))
    xl[:, :nl] = full.reshape(D, nl, d)
    return xl.reshape(D * P, d)


def _global(yl, D, nl, P, n):
    """The stacked local vector (D * P, d) -> global rows (n, d)."""
    d = yl.shape[1]
    return yl.reshape(D, P, d)[:, :nl].reshape(D * nl, d)[:n]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("nb,nh,n,seed", [
    (0, 50, 300, 0),        # a part with no halo rows
    (37, 90, 500, 1),
    (300, 1000, 2048, 2),
])
def test_halo_spmv_plain_matches_dense(nb, nh, n, seed, d, dtype):
    """``y[out_row] += A @ halo`` on random compact layouts (rows of 0-6
    entries, unique out_row) against the dense product added to a y that
    already holds values: f64 within 1e-12, f32 within 1e-5 of max|y|."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, nb)
    rows = np.repeat(np.arange(nb), deg)
    cols = rng.integers(0, nh, rows.size)
    A = sp.csr_matrix((rng.standard_normal(rows.size), (rows, cols)), shape=(nb, nh))
    op = sparse.sliced_from_scipy(A, dtype=dtype)
    out_row = np.sort(rng.choice(n, nb, replace=False)).astype(np.int32)
    hb = rng.standard_normal((nh, d))
    y0 = rng.standard_normal((n, d))
    want = y0.copy()
    want[out_row] += A.toarray() @ hb
    if d == 1:
        hb, y0, want = hb[:, 0], y0[:, 0], want[:, 0]
    y = torch.from_numpy(y0).to(dtype)
    args = (op.slice_ptr, op.col, op.val, torch.from_numpy(out_row),
            torch.from_numpy(hb).to(dtype), y)
    got = halo_spmv_plain(*args)
    assert got is y and got.shape == want.shape       # in place
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert np.abs(got.double().numpy() - want).max() <= tol * np.abs(want).max()
    y2 = torch.from_numpy(y0).to(dtype)
    assert torch.equal(halo_spmv(*args[:5], y2, op.tpr), got)   # CPU: the plain one


def test_stacked_a0_interior_layout_follows_the_gate():
    """A 524288-row periodic grid Laplacian over 4 partitions: its stacked
    interior (4096 row groups) is SlicedDiag at the solver's default gate,
    and SlicedEll with the gate raised above its group count; both apply
    the operator (f64, 1e-12 of max|y|)."""
    nu, nv = 512, 1024
    def ring(m):
        return sp.diags([np.ones(m - 1), np.ones(m - 1), [1.0], [1.0]],
                        [1, -1, m - 1, 1 - m], shape=(m, m))
    A = (4.5 * sp.identity(nu * nv) - sp.kron(ring(nu), sp.identity(nv))
         - sp.kron(sp.identity(nu), ring(nv))).tocsr()
    n, D = A.shape[0], 4
    nl, P = halo.partition_rows(n, D)
    plan = halo._halo_plan(A, D, nl, nl)
    groups = D * P // 128
    gate = inspect.signature(mg.MultigridSolveContext).parameters["diag_min_groups"].default
    assert groups >= gate
    mesh = make_solver_mesh(D, "cpu")
    xg = np.random.default_rng(0).standard_normal((n, 1))
    y_glob = A @ xg
    for min_groups, kind in ((gate, sparse.SlicedDiag), (groups + 1, sparse.SlicedEll)):
        op = halo.PartitionedOp(A, plan, mesh, P, P, torch.float64, min_groups)
        assert isinstance(op.A, kind)
        assert op.info()["interior"] == kind.__name__
        y = op(torch.from_numpy(_local(xg, D, nl, P))).numpy()
        assert np.abs(_global(y, D, nl, P, n) - y_glob).max() <= 1e-12 * np.abs(y_glob).max()


def test_halo_context_layouts():
    """On a torus context with a gate of 16 groups: every level interior
    takes the planner's rule (the finest is SlicedDiag), the transfers and
    M are SlicedEll, and every part with a halo has a compact part."""
    V, M, neigh, lhs = _torus_lhs(64, 48)
    solver = MultigridSolver(V, neigh, M, lower_bound=200, device="cpu",
                             diag_min_groups=16)
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, make_solver_mesh(4, "cpu"))
    assert isinstance(hctx.levels[0].A.A, sparse.SlicedDiag)
    for lvl in hctx.levels:
        assert isinstance(lvl.A.A, (sparse.SlicedDiag, sparse.SlicedEll))
        for t in (lvl.U.U, lvl.U.UT):
            assert isinstance(t.A, sparse.SlicedEll)
            assert t.Ah is not None and t.Ah.nrows > 0
    assert isinstance(hctx.M.A, sparse.SlicedEll)


@pytest.fixture(scope="module")
def medium_ops(medium_mesh):
    """The medium mesh's smoothing context: its A0, U0^T and M."""
    V, M, S = medium_mesh["V"], medium_mesh["M"], medium_mesh["S"]
    lhs = (M + 1e-3 * S).tocsr()
    solver = MultigridSolver(V, medium_mesh["neigh"], M, lower_bound=200, device="cpu")
    ctx = solver._context(lhs)
    n0, n1 = ctx.chain_csr[0].shape[0], ctx.chain_csr[1].shape[0]
    return {"A0": (ctx.chain_csr[0], n0, n0), "U0T": (ctx.U_csr[0].T.tocsr(), n1, n0),
            "M": (ctx.mass_csr, n0, n0)}


@pytest.mark.parametrize("D", [4, 8])
@pytest.mark.parametrize("which", ["A0", "U0T", "M"])
def test_halo_part_holds_the_boundary_rows(medium_ops, which, D):
    """The compact halo part's rows are exactly the rows with an
    off-partition column (none for the diagonal M), it stores at most 32
    entries per nonzero (a slice pads to its longest row), and the
    interior's real entries only source their own partition's columns."""
    A, nr, nc = medium_ops[which]
    rl, _ = halo.partition_rows(nr, D)
    cl, _ = halo.partition_rows(nc, D)
    p_out, p_in = halo.partition_rows(nr, D)[1], halo.partition_rows(nc, D)[1]
    op = halo.PartitionedOp(A, halo._halo_plan(A, D, rl, cl), make_solver_mesh(D, "cpu"),
                            p_in, p_out, torch.float64)
    coo = A.tocoo()
    part = coo.row // rl
    off = coo.col // cl != part
    boundary = np.unique(part[off] * p_out + coo.row[off] % rl)
    info = op.info()
    if which == "M":     # diagonal: no halo, no halo part, no exchange
        assert boundary.size == 0 and op.Ah is None and info["halo_rows"] == 0
    else:
        assert np.array_equal(op.out_row.numpy(), boundary)
        assert op.Ah.nnz == int(off.sum())
        assert op.Ah.col.numel() <= 32 * op.Ah.nnz
        assert info["halo_rows"] == boundary.size and info["halo_nnz"] == op.Ah.nnz
        assert info["halo_entries"] == op.Ah.col.numel() and info["halo_bytes"] > 0
    inner = op.A
    keep = inner.val.numpy() != 0
    rows = entry_rows(inner.slice_ptr).numpy()[keep]
    cols = inner.col.long().numpy()[keep]
    assert np.array_equal(cols // p_in, rows // p_out)
    assert (cols % p_in).max() < cl
    assert info["interior_bytes"] == inner.info()["bytes"]


def test_halo_buffer_keeps_no_stale_values():
    """One operator applied to x1 (d = 1), x2 (d = 3), then x3 (d = 1):
    each result equals the global product (f64, 1e-12 of max|y|), so the
    halo buffer kept per trailing shape holds nothing of an earlier apply
    that the next one reads."""
    _, _, _, A = _torus_lhs(64, 48)
    n, D = A.shape[0], 4
    nl, P = halo.partition_rows(n, D)
    op = halo.PartitionedOp(A, halo._halo_plan(A, D, nl, nl), make_solver_mesh(D, "cpu"),
                            P, P, torch.float64)
    rng = np.random.default_rng(9)
    for d in (1, 3, 1):
        xg = rng.standard_normal((n, d))
        xl = torch.from_numpy(_local(xg, D, nl, P))
        y = op(xl[:, 0] if d == 1 else xl).numpy().reshape(D * P, d)
        want = A @ xg
        assert np.abs(_global(y, D, nl, P, n) - want).max() <= 1e-12 * np.abs(want).max()
    assert len(op._buffers) == 2     # one per trailing shape, reused


def test_layout_rule_is_shared():
    """The planner, ``sliced_layout_from_scipy`` and the halo interiors
    take one rule: on a torus lhs, SlicedDiag at a gate at or below its
    group count, SlicedEll above it; the planner's plan agrees."""
    V, M, neigh, lhs = _torus_lhs(64, 48)
    groups = -(-lhs.shape[0] // 128)
    assert isinstance(sparse.sliced_layout_from_scipy(lhs, min_groups=groups),
                      sparse.SlicedDiag)
    assert isinstance(sparse.sliced_layout_from_scipy(lhs, min_groups=groups + 1),
                      sparse.SlicedEll)
    for gate, tag in ((groups, "sdiag"), (groups + 1, "sliced")):
        solver = MultigridSolver(V, neigh, M, lower_bound=200, device="cpu",
                                 diag_min_groups=gate)
        ctx = solver._context(lhs)
        assert ctx._plans[0][0] == tag
