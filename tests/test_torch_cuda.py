"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports nothing of JAX,
so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: relative to the largest output entry, 1e-5 in f32 and 1e-12
in f64 (the kernels sum slots in their own order, the plain versions in
torch's reduction order).  Solves go through sliced_spmv (and
sliced_diag_spmv where a level past the diagonal-run gate is SlicedDiag),
the halo path's boundary rows through halo_spmv; shuffle_spmv and
diag_spmv run on the JAX package's layouts only.  Every epilogue (of
sliced_spmv, sliced_diag_spmv and halo_spmv, and the row-masked interior
launches of the halo path) is held bitwise equal to the kernel's
plain-mode SpMV followed by the torch ops.  ``mode="fused"`` (the
captured cycle under a conditional WHILE node, one graph launch and one
host wait per warm solve) and CG's graphed 32-iteration unit are held
bitwise equal to the host loop and the eager unit, and so is the halo
solver's loop (``HaloContext.solve``) in one process, on a one-rank NCCL
group and, where two GPUs are present, across two NCCL ranks, whose
workers run this file as a script:

    python tests/test_torch_cuda.py nccl-halo-worker <rank> <world> <init file>
"""

import contextlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu_torch import MultigridSolver, sparse
from gravo_mg_tpu_torch.ops import diag_spmv as dmod
from gravo_mg_tpu_torch.ops import halo_spmv as hmod
from gravo_mg_tpu_torch.ops import shuffle_spmv as smod
from gravo_mg_tpu_torch.ops import sliced_diag_spmv as sdmod
from gravo_mg_tpu_torch.ops import sliced_spmv as slmod
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_voronoi
from gravo_mg_tpu_torch.utils.meshgen import icosphere
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

RTOL = {torch.float32: 1e-5, torch.float64: 1e-12}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def _coo(n, m, nnz, bw, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, nnz)
    if bw is None:
        cols = rng.integers(0, m, nnz)
    else:
        cols = np.clip(rows * m // n + rng.integers(-bw, bw + 1, nnz), 0, m - 1)
    rows = np.concatenate([rows, rows[: nnz // 8]])   # duplicates
    cols = np.concatenate([cols, cols[: nnz // 8]])
    return rows.astype(np.int64), cols.astype(np.int64), rng.standard_normal(rows.size)


def _fill(kp, s, pos, cols, vals, dtype):
    r = np.zeros((kp * s * 128,), np.int8)
    v = np.zeros((kp * s * 128,), sparse.numpy_dtype(dtype))
    r[pos] = (cols & 127).astype(np.int8)
    v[pos] = vals
    return torch.from_numpy(r.reshape(kp, s, 128)), torch.from_numpy(v.reshape(kp, s, 128))


def _x(m, d, dtype, seed, device):
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((m,) if d == 1 else (m, d))
    return torch.from_numpy(x).to(device, dtype)


def _close(got, ref, dtype):
    err = (got - ref).abs().max().item()
    assert err <= RTOL[dtype] * max(ref.abs().max().item(), 1e-30), err


MATRICES = [
    (1000, 1000, 7000, 30, 0),
    (70000, 70000, 400000, 300, 1),
    (5000, 5000, 10000, None, 2),
    (20000, 3000, 60000, 20, 3),
    (3000, 20000, 24000, 40, 4),
    (130, 130, 400, None, 5),
]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,nnz,bw,seed", MATRICES)
def test_shuffle_kernel_matches_plain(cuda, n, m, nnz, bw, seed, dtype, d):
    rows, cols, vals = _coo(n, m, nnz, bw, seed)
    kp, s, q, pos = sparse._shuffle_layout(rows, cols, n, m)
    r, v = _fill(kp, s, pos, cols, vals, dtype)
    q, r, v = torch.from_numpy(q).to(cuda), r.to(cuda), v.to(cuda)
    x = _x(m, d, dtype, seed, cuda)
    before = smod.launches
    y = smod.shuffle_spmv(q, r, v, x, n)
    torch.cuda.synchronize()
    assert smod.launches == before + 1
    ref = smod.shuffle_spmv_plain(q, r, v, x, n)
    assert y.shape == ref.shape and y.dtype == dtype
    _close(y, ref, dtype)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()
    host = torch.from_numpy(A @ x.double().cpu().numpy()).to(cuda, dtype)
    _close(y, host, dtype)


SLICED_MATRICES = MATRICES + [
    (200, 77, 500, None, 9),        # ncols not a multiple of 32
    (300, 300, 0, None, 10),        # every slice empty (filled below)
]


def _sliced_matrix(n, m, nnz, bw, seed):
    rows, cols, vals = _coo(n, m, nnz, bw, seed)
    if nnz == 0:    # four rows of 40 entries; the other slices stay empty
        rows = np.repeat(np.array([5, 70, 130, 290]), 40)
        cols = np.tile(np.arange(40) * 7, 4)
        vals = np.random.default_rng(seed).standard_normal(rows.size)
    return sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()


@pytest.mark.cuda
@pytest.mark.parametrize("tpr", [1, 2, 8, 32])
@pytest.mark.parametrize("d", [1, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,m,nnz,bw,seed", SLICED_MATRICES)
def test_sliced_kernel_matches_plain(cuda, n, m, nnz, bw, seed, dtype, d, tpr):
    """Both variants (one thread per row, and 2/8/32 threads per row with
    the shuffle reduction) against the plain version and a host f64
    product."""
    A = _sliced_matrix(n, m, nnz, bw, seed)
    op = sparse.sliced_from_scipy(A, dtype=dtype).to(cuda)
    x = _x(m, d, dtype, seed, cuda)
    before = slmod.launches
    y = slmod.sliced_spmv(op.slice_ptr, op.col, op.val, x, n, tpr)
    torch.cuda.synchronize()
    assert slmod.launches == before + 1
    ref = slmod.sliced_spmv_plain(op.slice_ptr, op.col, op.val, x, n)
    assert y.shape == ref.shape and y.dtype == dtype
    _close(y, ref, dtype)
    host = torch.from_numpy(A @ x.double().cpu().numpy()).to(cuda, dtype)
    _close(y, host, dtype)
    _close(sparse.spmv(op, x), host, dtype)     # the operator's own tpr


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("tg", [32, 128, 512])
@pytest.mark.parametrize("n,nnz,bw,seed", [
    (70000, 400000, 300, 6),
    (5000, 10000, None, 7),
    (300, 1200, 100, 8),
])
def test_diag_kernel_matches_plain(cuda, n, nnz, bw, seed, tg, dtype, d):
    rows, cols, vals = _coo(n, n, nnz, bw, seed)
    kp, s_pad, tg, start, pos = sparse._diag_layout(rows, cols, n, n, tg=tg)
    r, v = _fill(kp, s_pad, pos, cols, vals, dtype)
    start, r, v = torch.from_numpy(start).to(cuda), r.to(cuda), v.to(cuda)
    x = _x(n, d, dtype, seed, cuda)
    before = dmod.launches
    y = dmod.diag_spmv(start, r, v, x, tg, n)
    torch.cuda.synchronize()
    assert dmod.launches == before + 1
    ref = dmod.diag_spmv_plain(start, r, v, x, tg, n)
    assert y.shape == ref.shape and y.dtype == dtype
    _close(y, ref, dtype)


def _torus(nu, nv):
    from gravo_mg_tpu_torch.utils.laplacian import mass_barycentric
    from gravo_mg_tpu_torch.utils.meshgen import torus_mesh

    V, F = torus_mesh(nu, nv)
    return V, F, cotan_laplacian(V, F), mass_barycentric(V, F), neighbors_from_faces(F)


SLICED_DIAG_MATRICES = {
    "banded": (1000, 1000, 7000, 30, 0),
    "large": (70000, 70000, 400000, 100, 1),
    "ring_wraps": (1 << 20, 1 << 20, 4 << 20, 64, 12),   # 1M rows
    "all_wide": (5000, 5000, 10000, None, 2),
    "restriction": (20000, 3000, 60000, 20, 3),
    "prolongation": (3000, 20000, 24000, 40, 4),
    "small": (130, 130, 400, None, 5),
    "cols_77": (200, 77, 500, None, 9),       # rows, cols not multiples of 32
    "empty_slices": (300, 300, 0, None, 10),
}


def _sliced_diag_matrix(kind):
    if kind == "torus":                       # mixed: the v-wrap slices are wide
        _, _, S, M, _ = _torus(40, 300)
        return (1e-6 * M + S).tocsr()
    return _sliced_matrix(*SLICED_DIAG_MATRICES[kind])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", list(SLICED_DIAG_MATRICES) + ["torus"])
def test_sliced_diag_kernel_matches_plain(cuda, kind, dtype, d):
    """The kernel against the plain version and a host f64 product, on
    delta, wide and empty slices."""
    A = _sliced_diag_matrix(kind)
    op = sparse.sliced_diag_from_scipy(A, dtype=dtype).to(cuda)
    info = op.info()
    if kind == "all_wide":
        assert info["wide_slices"] == info["slices"]
    if kind == "torus":
        assert 0 < info["wide_slices"] < info["slices"]
    x = _x(A.shape[1], d, dtype, 3, cuda)
    before = sdmod.launches
    y = sdmod.sliced_diag_spmv(op.slice_ptr, op.base, op.delta, op.val, op.wide_ptr,
                               op.wide_col, x, op.nrows)
    torch.cuda.synchronize()
    assert sdmod.launches == before + 1
    ref = sdmod.sliced_diag_spmv_plain(op.slice_ptr, op.base, op.delta, op.val,
                                       op.wide_ptr, op.wide_col, x, op.nrows)
    assert y.shape == ref.shape and y.dtype == dtype
    _close(y, ref, dtype)
    host = torch.from_numpy(A @ x.double().cpu().numpy()).to(cuda, dtype)
    _close(y, host, dtype)
    _close(sparse.spmv(op, x), host, dtype)


# ---- the epilogues: one launch per operation of the cycle ------------------

EPILOGUE_OPS = ("residual", "add", "cheb_first", "cheb_next", "jacobi")


def _epilogue_case(op, n, m, d, dtype, device, seed=11):
    """The epilogue operands of ``op`` for an (n, m) operator (square for
    every op but add): (the fused call's keyword arguments, mode)."""
    rng = np.random.default_rng(seed)

    def v(rows, scale=1.0):
        a = scale * rng.standard_normal((rows,) if d == 1 else (rows, d))
        return torch.from_numpy(a).to(device, dtype)

    if op == "residual":
        return {"b": v(n)}, "residual"
    if op == "add":
        return {"z": v(n)}, "add"
    kw = {"b": v(n), "dinv": torch.from_numpy(0.5 + rng.random(n)).to(device, dtype),
          "d": None, "c1": None, "c2": 0.8391}
    if op == "cheb_next":
        kw.update(d=v(n, 0.1), c1=0.3717)
    return kw, "cheb"


def _check_epilogue(spmv_plain_mode, fused, op, x, kw, mode, mod):
    """``fused`` (the wrapper with epilogue ``mode``) against the kernel's
    own plain-mode SpMV followed by the torch ops of ``epilogue_plain``,
    bit for bit; each call adds one launch, to its mode."""
    from gravo_mg_tpu_torch.ops.epilogue import epilogue_plain

    y = spmv_plain_mode(x)
    before, by_mode = mod.launches, dict(mod.launches_by_mode)
    if mode == "cheb":
        keep = op != "jacobi"
        d_in = None if kw["d"] is None else kw["d"].clone()
        x_out, d_out = fused(x, kw["b"], kw["dinv"], d_in, kw["c1"], kw["c2"], keep)
        ref_x, ref_d = epilogue_plain("cheb", y, x=x, **kw)
        assert torch.equal(x_out, ref_x)
        if keep:
            assert torch.equal(d_out, ref_d)
            if d_in is not None:
                assert d_out is d_in          # written in place
        else:
            assert d_out is None
    else:
        vec = kw["b"] if mode == "residual" else kw["z"]
        got = fused(x, vec)
        assert got.shape == y.shape and got.dtype == y.dtype
        assert torch.equal(got, epilogue_plain(mode, y, **kw))
    torch.cuda.synchronize()
    assert mod.launches == before + 1
    assert mod.launches_by_mode[mode] == by_mode[mode] + 1
    assert sum(mod.launches_by_mode.values()) == sum(by_mode.values()) + 1


# square operators (every op), and rectangular ones for the add
SLICED_EPILOGUE = [(op, case) for op in EPILOGUE_OPS
                   for case in ((1000, 1000, 7000, 30, 0), (130, 130, 400, None, 5),
                                (300, 300, 0, None, 10))] + [
    ("add", (20000, 3000, 60000, 20, 3)), ("add", (200, 77, 500, None, 9))]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op,case", SLICED_EPILOGUE)
def test_sliced_epilogue_matches_kernel_then_torch(cuda, op, case, dtype, d):
    """Every epilogue of sliced_spmv at every threads-per-row count, with
    nrows not a multiple of 32 and d = 9 over two grid columns, equal bit
    for bit to the plain-mode kernel followed by the torch ops."""
    A = _sliced_matrix(*case)
    n, m = A.shape
    o = sparse.sliced_from_scipy(A, dtype=dtype).to(cuda)
    x = _x(m, d, dtype, 2, cuda)
    kw, mode = _epilogue_case(op, n, m, d, dtype, cuda)
    for tpr in slmod.TPRS:
        args = (o.slice_ptr, o.col, o.val)
        fused = {
            "residual": lambda x, b: slmod.sliced_spmv_residual(*args, x, b, n, tpr),
            "add": lambda x, z: slmod.sliced_spmv_add(*args, x, z, n, tpr),
            "cheb": lambda x, b, dinv, dd, c1, c2, keep: slmod.sliced_spmv_cheb(
                *args, x, b, dinv, dd, c1, c2, n, tpr, keep),
        }[mode]
        _check_epilogue(lambda x: slmod.sliced_spmv(*args, x, n, tpr), fused, op, x,
                        kw, mode, slmod)


# sliced_diag_spmv has no add (no transfer is SlicedDiag)
SDIAG_EPILOGUE = [(op, kind) for op in EPILOGUE_OPS if op != "add"
                  for kind in ("banded", "all_wide", "small", "empty_slices",
                               "torus")]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op,kind", SDIAG_EPILOGUE)
def test_sliced_diag_epilogue_matches_kernel_then_torch(cuda, op, kind, dtype, d):
    """Every epilogue of sliced_diag_spmv on delta, wide, mixed and empty
    slices, nrows not a multiple of 32, d = 9 over three grid columns:
    equal bit for bit to the plain-mode kernel followed by the torch ops."""
    A = _sliced_diag_matrix(kind)
    n, m = A.shape
    o = sparse.sliced_diag_from_scipy(A, dtype=dtype).to(cuda)
    x = _x(m, d, dtype, 2, cuda)
    kw, mode = _epilogue_case(op, n, m, d, dtype, cuda)
    args = (o.slice_ptr, o.base, o.delta, o.val, o.wide_ptr, o.wide_col)
    fused = {
        "residual": lambda x, b: sdmod.sliced_diag_spmv_residual(*args, x, b, n),
        "cheb": lambda x, b, dinv, dd, c1, c2, keep: sdmod.sliced_diag_spmv_cheb(
            *args, x, b, dinv, dd, c1, c2, n, keep),
    }[mode]
    _check_epilogue(lambda x: sdmod.sliced_diag_spmv(*args, x, n), fused, op, x, kw,
                    mode, sdmod)


@pytest.mark.cuda
def test_wrappers_validate_operands(cuda):
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda)
    r = torch.zeros((4, 8, 128), dtype=torch.int8, device=cuda)
    v = torch.zeros((4, 8, 128), device=cuda)
    x = torch.zeros(100, device=cuda)
    with pytest.raises(TypeError):
        smod.shuffle_spmv(q, r.int(), v, x, 100)
    with pytest.raises(TypeError):
        smod.shuffle_spmv(q, r, v, x.double(), 100)
    with pytest.raises(ValueError):
        smod.shuffle_spmv(q.cpu(), r, v, x, 100)
    with pytest.raises(ValueError):
        dmod.diag_spmv(q[:1], r, v, x, 3, 100)
    ptr = torch.zeros(5, dtype=torch.int64, device=cuda)
    col = torch.zeros(0, dtype=torch.int32, device=cuda)
    val = torch.zeros(0, device=cuda)
    with pytest.raises(TypeError):
        slmod.sliced_spmv(ptr.int(), col, val, x, 100)
    with pytest.raises(TypeError):
        slmod.sliced_spmv(ptr, col, val, x.double(), 100)
    with pytest.raises(ValueError):
        slmod.sliced_spmv(ptr, col, val, x, 200)      # 7 slices, 4 given
    with pytest.raises(ValueError):
        slmod.sliced_spmv(ptr, col, val, x, 100, tpr=3)
    with pytest.raises(ValueError):
        slmod.sliced_spmv(ptr.cpu(), col, val, x, 100)
    op = sparse.sliced_diag_from_scipy(_sliced_diag_matrix("banded")).to(cuda)
    args = [op.slice_ptr, op.base, op.delta, op.val, op.wide_ptr, op.wide_col]
    x = torch.zeros(op.ncols, device=cuda)
    sdmod.sliced_diag_spmv(*args, x, op.nrows)
    for k, bad in ((0, op.slice_ptr.int()), (1, op.base.long()), (2, op.delta.int()),
                   (5, op.wide_col.long())):
        with pytest.raises(TypeError):
            sdmod.sliced_diag_spmv(*args[:k], bad, *args[k + 1:], x, op.nrows)
    with pytest.raises(TypeError):
        sdmod.sliced_diag_spmv(*args, x.double(), op.nrows)
    with pytest.raises(ValueError):
        sdmod.sliced_diag_spmv(*args, x, op.nrows + 64)   # slices disagree
    with pytest.raises(ValueError):
        sdmod.sliced_diag_spmv(*args[:3], op.val[:-32], *args[4:], x, op.nrows)
    with pytest.raises(ValueError):
        sdmod.sliced_diag_spmv(*args[:5], op.wide_col.cpu(), x, op.nrows)
    # the epilogues' operands: shape, dtype, device, and d never sharing x's memory
    b = torch.zeros(op.nrows, device=cuda)
    dinv = torch.ones(op.nrows, device=cuda)
    with pytest.raises(ValueError):
        sdmod.sliced_diag_spmv_residual(*args, x, b[:-1], op.nrows)
    with pytest.raises(TypeError):
        sdmod.sliced_diag_spmv_residual(*args, x, b.double(), op.nrows)
    with pytest.raises(ValueError):
        sdmod.sliced_diag_spmv_residual(*args, x, b.cpu(), op.nrows)
    mask = torch.zeros(-(-op.nrows // 32), dtype=torch.int32, device=cuda)
    for bad in (mask[:-1], mask.long(), mask.cpu()):
        with pytest.raises(ValueError):
            sdmod.sliced_diag_spmv_residual(*args, x, b, op.nrows, row_mask=bad)
    with pytest.raises(ValueError):     # a step with c1 needs the previous d
        sdmod.sliced_diag_spmv_cheb(*args, x, b, dinv, None, 0.5, 1.0, op.nrows)
    with pytest.raises(ValueError):
        sdmod.sliced_diag_spmv_cheb(*args, x, b, dinv, x, 0.5, 1.0, op.nrows)
    h = sparse.sliced_from_scipy(_sliced_matrix(200, 77, 500, None, 9)).to(cuda)
    out_row = torch.arange(200, dtype=torch.int32, device=cuda)
    hb, y = torch.zeros(77, device=cuda), torch.zeros(300, device=cuda)
    hmod.halo_spmv(h.slice_ptr, h.col, h.val, out_row, hb, y)
    with pytest.raises(TypeError):
        hmod.halo_spmv(h.slice_ptr, h.col, h.val, out_row.long(), hb, y)
    with pytest.raises(ValueError):
        hmod.halo_spmv(h.slice_ptr, h.col, h.val, out_row, hb, y[:, None])
    with pytest.raises(TypeError):
        hmod.halo_spmv(h.slice_ptr, h.col, h.val, out_row, hb, y.double())
    with pytest.raises(ValueError):
        hmod.halo_spmv(h.slice_ptr, h.col, h.val, out_row[:100], hb, y)   # slices
    with pytest.raises(ValueError):     # the Chebyshev step needs a square A
        slmod.sliced_spmv_cheb(h.slice_ptr, h.col, h.val, torch.zeros(77, device=cuda),
                               torch.zeros(200, device=cuda),
                               torch.ones(200, device=cuda), None, None, 1.0, 200)
    # halo_spmv's epilogues: vectors of y's shape, y never sharing their memory
    hargs = (h.slice_ptr, h.col, h.val, out_row, hb)
    z = torch.zeros(300, device=cuda)
    hmod.halo_spmv_add(*hargs, y, z)
    with pytest.raises(ValueError):
        hmod.halo_spmv_residual(*hargs, y, z[:-1])
    with pytest.raises(ValueError):
        hmod.halo_spmv_add(*hargs, y, y)
    with pytest.raises(ValueError):     # a later step reads the previous d
        hmod.halo_spmv_cheb(*hargs, y, z, z.clone(), torch.ones(300, device=cuda),
                            None, 0.5, 1.0)
    with pytest.raises(ValueError):
        hmod.halo_spmv_cheb(*hargs, y, z, z.clone(), torch.ones(300, device=cuda),
                            z, 0.5, 1.0)


def _reset_launches():
    smod.launches = dmod.launches = slmod.launches = sdmod.launches = 0
    hmod.launches = 0
    for mod in (slmod, sdmod, hmod):
        mod.launches_by_mode.update(dict.fromkeys(mod.launches_by_mode, 0))


@pytest.mark.cuda
def test_solve_on_cuda_goes_through_both_kernels(cuda):
    """sliced_spmv and sliced_diag_spmv (the finest level, 128 row groups,
    passes the gate of 16 and is SlicedDiag), and neither shuffle_spmv
    (the halo path's) nor diag_spmv (the JAX layout's)."""
    V, F, S, M, neigh = _torus(128, 128)
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ np.random.default_rng(1).standard_normal((len(V), 2))
    runs = {}
    for device in ("cpu", "cuda"):
        solver = MultigridSolver(V, neigh, M, lower_bound=200, device=device,
                                 diag_min_groups=16)
        _reset_launches()
        x = solver.solve(lhs, rhs)
        ctx = next(iter(solver._contexts.values()))
        runs[device] = (solver.solver_timing["iterations"],
                        solver.residual(lhs, rhs, x), slmod.launches,
                        sdmod.launches, dmod.launches, smod.launches,
                        type(ctx.levels[0].A))
    iters, res, n_sliced, n_sdiag, n_diag, n_shuffle, kind = runs["cuda"]
    assert iters == runs["cpu"][0] and kind is sparse.SlicedDiag
    assert res <= 1e-4
    assert n_sliced > 0 and n_sdiag > 0 and n_diag == 0 and n_shuffle == 0
    assert runs["cpu"][2:6] == (0, 0, 0, 0)


@pytest.mark.cuda
def test_cg_on_cuda_launches_shuffle_and_meets_tol(cuda):
    from gravo_mg_tpu_torch.solver.direct import cg_solve

    V, F, S, M, neigh = _torus(256, 256)          # 65536 vertices
    lhs = (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(42).standard_normal((len(V), 3))
    _reset_launches()
    timing = {}
    x = cg_solve(lhs, rhs, tol=1e-4, max_iter=2000, device=cuda, timing=timing)
    # the torus operator is SlicedDiag (the byte rule)
    assert sdmod.launches >= timing["cg_iterations"] > 0 == slmod.launches
    assert np.linalg.norm(lhs @ x - rhs) <= 1.1e-4 * np.linalg.norm(rhs)


@pytest.mark.cuda
def test_min_quad_on_cuda_matches_cpu(cuda):
    from gravo_mg_tpu_torch import MinQuadWithFixedMG

    V, F, S, M, neigh = _torus(128, 128)
    n = len(V)
    rng = np.random.default_rng(3)
    known = rng.choice(n, size=n // 20, replace=False)
    Y = rng.standard_normal(known.size)
    lhs = (S + 1e-3 * M).tocsr()
    B = M @ rng.standard_normal(n)
    out = {}
    for device in ("cpu", "cuda"):
        solver = MultigridSolver(V, neigh, M, lower_bound=200, device=device,
                                 diag_min_groups=16)
        _reset_launches()
        mq = MinQuadWithFixedMG(solver, lhs, known, tol=1e-4, max_iter=20,
                                criteria=2)
        out[device] = mq.solve(B, Y)[0], slmod.launches, sdmod.launches, dmod.launches
    x_cpu, x_gpu = out["cpu"][0], out["cuda"][0]
    assert np.array_equal(x_gpu[known], Y)
    assert np.linalg.norm(x_gpu - x_cpu) <= 1e-4 * np.linalg.norm(x_cpu)
    assert out["cuda"][1] > 0 and out["cuda"][2] > 0 and out["cuda"][3] == 0
    assert out["cpu"][1:] == (0, 0, 0)


@pytest.mark.cuda
def test_sig21_solve_on_cuda_goes_through_both_kernels(cuda):
    from gravo_mg_tpu_torch import Hierarchy

    V, F = icosphere(5, bump=0.1)
    S, M, neigh = cotan_laplacian(V, F), mass_voronoi(V, F), neighbors_from_faces(F)
    lhs = (M + 1e-3 * S).tocsr()
    rhs = M @ V
    solver = MultigridSolver(V, neigh, M, lower_bound=300, device=cuda,
                             diag_min_groups=16)
    solver.construct_sig21_hierarchy(F)
    solver.toggle_hierarchy(Hierarchy.SIG21)
    _reset_launches()
    x = solver.solve(lhs, rhs)
    ctx = next(iter(solver._contexts.values()))
    finest_diag = isinstance(ctx.levels[0].A, sparse.SlicedDiag)   # the byte rule
    assert slmod.launches > 0 and (sdmod.launches > 0) == finest_diag
    assert dmod.launches == 0
    assert solver.residual(lhs, rhs, x) <= 1e-4


@pytest.mark.cuda
def test_f64_smoothing_to_1e12_on_cuda(cuda):
    V, F, S, M, neigh = _torus(224, 224)          # 50176 vertices
    solver = MultigridSolver(V, neigh, M, lower_bound=500, tolerance=1e-12,
                             dtype=torch.float64, device=cuda)
    lhs = (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(0).standard_normal(len(V))
    slmod.launches = 0
    x = solver.solve(lhs, rhs)
    assert slmod.launches > 0
    assert solver.residual(lhs, rhs, x) < 1e-12
    assert solver.solver_timing["iterations"] <= 40


@pytest.fixture(scope="module")
def halo_torus():
    V, F, S, M, neigh = _torus(128, 96)            # 12288 vertices
    lhs = (M + 1e-3 * S).tocsr()
    return V, M, neigh, lhs


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("D", [2, 4, 8])
def test_halo_solve_on_cuda_matches_single_device(cuda, halo_torus, D, dtype, d):
    """D virtual partitions on the card against the single-device solve on
    the card: the same cycles (+-1), solutions within 1e-4 (f32) or 1e-9
    (f64) of max|x|, through the sliced kernels (the stacked finest
    interior SlicedDiag) and halo_spmv, and never shuffle_spmv."""
    from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh

    V, M, neigh, lhs = halo_torus
    rhs = M @ np.random.default_rng(d).standard_normal((len(V), d))
    rhs = rhs[:, 0] if d == 1 else rhs
    tol = 1e-5 if dtype == torch.float32 else 1e-10
    solver = MultigridSolver(V, neigh, M, lower_bound=200, dtype=dtype,
                             device=cuda, diag_min_groups=16)
    ctx = solver._context(lhs)
    x1, it1, _, _ = ctx.solve(rhs, tol=tol, max_iter=50)
    hctx = HaloContext(ctx, make_solver_mesh(D, cuda))
    assert isinstance(hctx.levels[0].A.A, sparse.SlicedDiag)
    _reset_launches()
    x2, it2, res = hctx.solve(rhs, tol=tol, max_iter=50)
    assert sdmod.launches > 0 and slmod.launches > 0 and hmod.launches > 0
    assert smod.launches == 0 and dmod.launches == 0
    assert res <= tol and abs(it1 - it2) <= 1
    rel = 1e-4 if dtype == torch.float32 else 1e-9
    assert np.abs(x1 - x2).max() <= rel * np.abs(x1).max()
    assert solver.residual(lhs, rhs, x2) <= 2 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("which", ["A0", "M"])
def test_halo_stacked_apply_on_cuda_matches_plain(cuda, halo_torus, dtype, which):
    """The stacked apply (one interior launch, one halo_spmv launch for all
    four partitions) on the card against the same apply through the plain
    versions on the CPU (tests/test_torch_halo.py holds the plain apply
    equal to the per-partition applies of the reference layout)."""
    from gravo_mg_tpu_torch.parallel import halo

    V, M, neigh, lhs = halo_torus
    A = lhs if which == "A0" else M.tocsr()
    D = 4
    nl, P = halo.partition_rows(A.shape[0], D)
    plan = halo._halo_plan(A, D, nl, nl)
    stacked = halo.PartitionedOp(A, plan, halo.make_solver_mesh(D, cuda), P, P, dtype, 16)
    x = _x(D * P, 3, dtype, 11, cuda)
    x.view(D, P, 3)[:, nl:] = 0
    _reset_launches()
    y = stacked(x)
    torch.cuda.synchronize()
    assert slmod.launches + sdmod.launches == 1 and smod.launches == 0
    assert hmod.launches == (stacked.Ah is not None)
    host = halo.PartitionedOp(A, plan, halo.make_solver_mesh(D, "cpu"), P, P, dtype, 16)
    ref = host(x.cpu())
    _close(y.cpu(), ref, dtype)


HALO_PARTS = [
    (0, 50, 300, 0),          # no boundary rows: nothing launches
    (37, 90, 500, 1),
    (3000, 9000, 20000, 2),
    (8192, 9000, 1 << 20, 3),
]


@pytest.mark.cuda
@pytest.mark.parametrize("tpr", slmod.TPRS)
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nb,nh,n,seed", HALO_PARTS)
def test_halo_kernel_matches_plain(cuda, nb, nh, n, seed, dtype, d, tpr):
    """halo_spmv against halo_spmv_plain on random compact parts (rows of
    0-6 entries, unique out_row) added into a y that already holds
    interior values, every threads-per-row variant; an empty part
    launches nothing."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, nb)
    rows = np.repeat(np.arange(nb), deg)
    A = sp.csr_matrix((rng.standard_normal(rows.size),
                       (rows, rng.integers(0, nh, rows.size))), shape=(nb, nh))
    op = sparse.sliced_from_scipy(A, dtype=dtype).to(cuda)
    out_row = torch.from_numpy(
        np.sort(rng.choice(n, nb, replace=False)).astype(np.int32)).to(cuda)
    hb = _x(nh, d, dtype, seed, cuda)
    y0 = _x(n, d, dtype, seed + 1, cuda)
    before = hmod.launches
    y = hmod.halo_spmv(op.slice_ptr, op.col, op.val, out_row, hb, y0.clone(), tpr)
    torch.cuda.synchronize()
    assert hmod.launches == before + (nb > 0)
    ref = hmod.halo_spmv_plain(op.slice_ptr, op.col, op.val, out_row, hb, y0.clone())
    assert y.shape == ref.shape and y.dtype == dtype
    _close(y, ref, dtype)
    host = y0.double().cpu().numpy().copy()
    host[out_row.long().cpu().numpy()] += A @ hb.double().cpu().numpy()
    _close(y, torch.from_numpy(host).to(cuda, dtype), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op", EPILOGUE_OPS)
@pytest.mark.parametrize("nb,nh,n,seed", HALO_PARTS)
def test_halo_epilogue_matches_kernel_then_torch(cuda, nb, nh, n, seed, op, dtype, d):
    """Every epilogue of halo_spmv at every threads-per-row count, bitwise
    equal to the plain-mode halo_spmv launch followed by the torch ops on
    the out rows (b, dinv, x and d taken there); the other rows of y and d
    untouched; one launch each, to its mode, and none for an empty part."""
    from gravo_mg_tpu_torch.ops.epilogue import epilogue_plain

    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 7, nb)
    rows = np.repeat(np.arange(nb), deg)
    A = sp.csr_matrix((rng.standard_normal(rows.size),
                       (rows, rng.integers(0, nh, rows.size))), shape=(nb, nh))
    h = sparse.sliced_from_scipy(A, dtype=dtype).to(cuda)
    out_row = torch.from_numpy(
        np.sort(rng.choice(n, nb, replace=False)).astype(np.int32)).to(cuda)
    args = (h.slice_ptr, h.col, h.val, out_row, _x(nh, d, dtype, seed, cuda))
    kw, mode = _epilogue_case(op, n, n, d, dtype, cuda)
    x = _x(n, d, dtype, seed + 2, cuda)                  # the iterate
    keep = op != "jacobi"
    d_buf = kw["d"] if kw.get("d") is not None else (
        _x(n, d, dtype, seed + 3, cuda) if mode == "cheb" and keep else None)
    o = out_row.long()

    def at(t):
        return t.index_select(0, o)

    for tpr in slmod.TPRS:
        y0 = _x(n, d, dtype, seed + 1, cuda)
        ref = hmod.halo_spmv(*args, y0.clone(), tpr)     # the plain-mode launch
        before, by_mode = hmod.launches, dict(hmod.launches_by_mode)
        want = y0.clone()
        if mode == "cheb":
            d_in = None if d_buf is None else d_buf.clone()
            y, d_out = hmod.halo_spmv_cheb(*args, y0.clone(), x, kw["b"], kw["dinv"],
                                           d_in, kw["c1"], kw["c2"], tpr)
            got_x, got_d = epilogue_plain(
                "cheb", at(ref), b=at(kw["b"]), dinv=at(kw["dinv"]), x=at(x),
                d=None if kw["c1"] is None else at(d_buf), c1=kw["c1"], c2=kw["c2"],
                keep_d=keep)
            want[o] = got_x
            assert torch.equal(y, want)
            if keep:
                want_d = d_buf.clone()
                want_d[o] = got_d
                assert d_out is d_in and torch.equal(d_out, want_d)
            else:
                assert d_out is None
        else:
            vec = kw["b"] if mode == "residual" else kw["z"]
            fn = hmod.halo_spmv_residual if mode == "residual" else hmod.halo_spmv_add
            y = fn(*args, y0.clone(), vec, tpr)
            want[o] = epilogue_plain(mode, at(ref), **{k: at(v) for k, v in kw.items()})
            assert torch.equal(y, want)
        torch.cuda.synchronize()
        assert hmod.launches == before + (nb > 0)
        assert hmod.launches_by_mode[mode] == by_mode[mode] + (nb > 0)


MASKED_INTERIOR = [(op, kind) for kind in ("sliced", "sdiag") for op in EPILOGUE_OPS
                   if not (kind == "sdiag" and op == "add")]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("op,kind", MASKED_INTERIOR)
def test_masked_interior_matches_kernel_then_torch(cuda, op, kind, dtype, d):
    """The row-masked launches of sliced_spmv (every threads-per-row
    count) and sliced_diag_spmv (delta and wide slices): the epilogue on
    the rows whose bit is clear, bitwise as the plain-mode kernel followed
    by the torch ops; the raw sum on the others, where d is neither read
    nor written (a slice all boundary rows, one with none)."""
    from gravo_mg_tpu_torch.ops.epilogue import (
        epilogue_plain, masked_rows, row_mask_from_rows,
    )

    A = (_sliced_matrix(1000, 1000, 7000, 30, 0) if kind == "sliced"
         else _sliced_diag_matrix("torus"))
    n = A.shape[0]
    rng = np.random.default_rng(4)
    rows = np.union1d(np.arange(32), rng.choice(n, n // 3, replace=False))
    rows = rows[(rows < 32) | (rows >= 64)]
    mask = row_mask_from_rows(rows, n).to(cuda)
    m = masked_rows(mask, n)
    m = m[:, None] if d > 1 else m
    x = _x(n, d, dtype, 2, cuda)
    kw, mode = _epilogue_case(op, n, n, d, dtype, cuda)
    if kind == "sliced":
        o = sparse.sliced_from_scipy(A, dtype=dtype).to(cuda)
        a = (o.slice_ptr, o.col, o.val)
        runs = [(lambda x, t=tpr: slmod.sliced_spmv(*a, x, n, t), {
            "residual": lambda x, b, t=tpr: slmod.sliced_spmv_residual(
                *a, x, b, n, t, row_mask=mask),
            "add": lambda x, z, t=tpr: slmod.sliced_spmv_add(*a, x, z, n, t,
                                                             row_mask=mask),
            "cheb": lambda x, b, dinv, dd, c1, c2, keep, t=tpr: slmod.sliced_spmv_cheb(
                *a, x, b, dinv, dd, c1, c2, n, t, keep, row_mask=mask)}, slmod)
            for tpr in slmod.TPRS]
    else:
        o = sparse.sliced_diag_from_scipy(A, dtype=dtype).to(cuda)
        a = (o.slice_ptr, o.base, o.delta, o.val, o.wide_ptr, o.wide_col)
        runs = [(lambda x: sdmod.sliced_diag_spmv(*a, x, n), {
            "residual": lambda x, b: sdmod.sliced_diag_spmv_residual(
                *a, x, b, n, row_mask=mask),
            "cheb": lambda x, b, dinv, dd, c1, c2, keep: sdmod.sliced_diag_spmv_cheb(
                *a, x, b, dinv, dd, c1, c2, n, keep, row_mask=mask)}, sdmod)]
    for spmv_plain_mode, fns, mod in runs:
        y = spmv_plain_mode(x)
        before, by_mode = mod.launches, dict(mod.launches_by_mode)
        if mode == "cheb":
            keep = op != "jacobi"
            d_in = None if kw["d"] is None else kw["d"].clone()
            x_out, d_out = fns["cheb"](x, kw["b"], kw["dinv"], d_in, kw["c1"], kw["c2"],
                                       keep)
            ref_x, ref_d = epilogue_plain("cheb", y, x=x, keep_d=keep, row_mask=mask,
                                          **kw)
            assert torch.equal(x_out, ref_x)
            if not keep:
                assert d_out is None
            elif d_in is None:       # a first step's d: unwritten on masked rows
                zero = torch.zeros_like(ref_d)
                assert torch.equal(torch.where(m, zero, d_out), ref_d)
            else:
                assert d_out is d_in and torch.equal(d_out, ref_d)
        else:
            vec = kw["b"] if mode == "residual" else kw["z"]
            got = fns[mode](x, vec)
            assert torch.equal(got, epilogue_plain(mode, y, row_mask=mask, **kw))
            assert torch.equal(torch.where(m, got, y), y)
        torch.cuda.synchronize()
        assert mod.launches == before + 1
        assert mod.launches_by_mode[mode] == by_mode[mode] + 1


@pytest.fixture(scope="module")
def torus_65k():
    from gravo_mg_tpu_torch.utils.meshgen import torus_mesh

    V, F = torus_mesh(256, 256)
    return V, neighbors_from_faces(F)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["ours", "sig06", "ablation"])
def test_device_hierarchy_on_cuda_matches_cpu(cuda, torus_65k, kind):
    """The device engines (Luby sampling, Bellman-Ford clustering, batched
    weights) on the card against the same engines on the CPU, 65k torus:
    equal dof, samples, labels, coarse graphs and rounds at every level;
    U as sparse rows within 1e-5 on >= 99.9% of rows (f32 geometry), rows
    summing to 1 within 1e-6, branch stats within 0.1% of N."""
    from gravo_mg_tpu_torch.hierarchy import builder, variants

    build = {"ours": builder.build_hierarchy,
             "sig06": variants.build_hierarchy_sig06,
             "ablation": variants.build_hierarchy_ablation}[kind]
    V, neigh = torus_65k
    got = build(V, neigh, lower_bound=1000, seed=1, engine="device", device=cuda)
    ref = build(V, neigh, lower_bound=1000, seed=1, engine="device", device="cpu")
    assert got.dof == ref.dof and len(got.dof) >= 3
    for a, b in zip(got.levels, ref.levels):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.coarse_neigh, b.coarse_neigh)
        assert a.rounds == b.rounds
        n = a.labels.shape[0]
        Ua, Ub = a.U.to_scipy().tocsr(), b.U.to_scipy().tocsr()
        D = abs(Ua - Ub).tocsr()
        row_err = np.zeros(n)
        np.maximum.at(row_err, np.repeat(np.arange(n), np.diff(D.indptr)), D.data)
        assert (row_err > 1e-5).sum() <= 1e-3 * n
        np.testing.assert_allclose(np.asarray(Ua.sum(axis=1)).ravel(), 1.0, atol=1e-6)
        assert np.abs(a.stats - b.stats).max() <= 1e-3 * n


# ---- mode="fused": the captured cycle under a conditional WHILE node -------

@pytest.fixture(scope="module")
def fused_torus():
    V, F, S, M, neigh = _torus(256, 256)           # 65536 vertices
    rng = np.random.default_rng(42)
    return V, S, M, neigh, rng.standard_normal((len(V), 3))


def _fused_solver(V, M, neigh, dtype):
    # the finest level (512 row groups) alone passes the gate of 256: it is
    # SlicedDiag, 9 applies per cycle and one in the residual
    return MultigridSolver(V, neigh, M, lower_bound=1000, device="cuda",
                           dtype=dtype, diag_min_groups=256)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 1), (torch.float32, 3),
                                     (torch.float64, 1), (torch.float64, 3)])
def test_fused_graph_matches_traced_bitwise(cuda, fused_torus, dtype, d):
    """The same kernels in the same order: the WHILE graph's iterate, cycle
    count and trace equal the host loop's bit for bit.  One capture and
    one build serve repeated solves; the cold solve runs its first cycle
    eagerly and reads the flag once, then launches the graph; a warm solve
    is one launch and one host wait; sliced_diag_spmv counts 10 launches
    per cycle the card ran."""
    V, S, M, neigh, noise = fused_torus
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ (noise[:, 0] if d == 1 else noise)
    solver = _fused_solver(V, M, neigh, dtype)
    ctx = solver._context(lhs)
    assert isinstance(ctx.levels[0].A, sparse.SlicedDiag)
    traced = ctx.solve(rhs, mode="traced")
    for solve in range(3):
        _reset_launches()
        fused = ctx.solve(rhs, mode="fused")
        assert fused[1] == traced[1] and fused[2] == traced[2]
        assert np.array_equal(fused[0], traced[0])
        assert [r for _, r in fused[3]] == [r for _, r in traced[3]]
        t = ctx.timing
        assert t["graph_captures"] == 1 and t["graph_launches"] == 1
        assert t["host_reads"] == (2 if solve == 0 else 1)
        assert ctx.dispatched == fused[1] > 1
        assert sdmod.launches == 10 * ctx.dispatched and slmod.launches > 0
        assert dmod.launches == smod.launches == 0
    assert solver.residual(lhs, rhs, fused[0]) <= 1e-4
    (loop,) = ctx._fused.values()
    assert loop.graph.launches == 3 and loop.graph.build_ms > 0
    assert loop.graph.step_nodes["kernel"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 1), (torch.float64, 3)])
def test_device_deflation_on_cuda_matches_host(cuda, fused_torus, monkeypatch,
                                               dtype, d):
    """The solve's alpha, formed on the card in f64, within 1e-12 of the
    host's ``deflation_alpha``; the answer bit for bit the WHILE graph's
    iterate in f64 plus that alpha added on the host, cold and warm."""
    from gravo_mg_tpu_torch.solver import multigrid as mg

    V, S, M, neigh, noise = fused_torus
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ (noise[:, 0] if d == 1 else noise)
    ctx = _fused_solver(V, M, neigh, dtype)._context(lhs)
    seen = []
    deflate, run = mg.device_deflation, mg.FusedLoop.run

    def device_deflation(*a):
        out = deflate(*a)
        seen.append(out[0].cpu())
        return out

    def fused_run(loop, *a):
        out = run(loop, *a)
        seen.append(out[0].double().cpu().numpy())
        return out

    monkeypatch.setattr(mg, "device_deflation", device_deflation)
    monkeypatch.setattr(mg.FusedLoop, "run", fused_run)
    rhs2 = rhs[:, None] if d == 1 else rhs
    want = mg.deflation_alpha(ctx.row_sums, rhs2, ctx.diag_scale)
    for _ in range(2):
        seen.clear()
        x = ctx.solve(rhs, mode="fused")[0]
        alpha, y = seen
        assert alpha.dtype == torch.float64 and alpha.shape == (d,)
        np.testing.assert_allclose(alpha.numpy(), want, rtol=1e-12, atol=0)
        host = (y[:, None] if d == 1 else y) + alpha.numpy()[None, :]
        assert np.array_equal(x, host[:, 0] if d == 1 else host)
        assert ctx.timing["deflated_columns"] == d


@pytest.mark.cuda
def test_fused_graph_stops_as_traced(cuda, fused_torus):
    """A warm solve whose first cycle meets tol runs one body; tol 0 with
    max_iter 3 runs 3 bodies and keeps 3 trace entries; both one launch,
    one host wait, and equal to the host loop."""
    V, S, M, neigh, noise = fused_torus
    solver = _fused_solver(V, M, neigh, torch.float32)
    ctx = solver._context((M + 1e-3 * S).tocsr())
    rhs = M @ noise[:, 0]
    for kw, want in ((dict(tol=0.5), 1), (dict(tol=0.0, max_iter=3), 3)):
        traced = ctx.solve(rhs, mode="traced", **kw)
        ctx.solve(rhs, mode="fused", tol=1e-6, **{k: v for k, v in kw.items()
                                                   if k != "tol"})  # cold
        _reset_launches()
        fused = ctx.solve(rhs, mode="fused", **kw)
        assert fused[1] == traced[1] == want and len(fused[3]) == want
        assert fused[2] == traced[2] and np.array_equal(fused[0], traced[0])
        t = ctx.timing
        assert t["graph_launches"] == 1 and t["host_reads"] == 1
        assert ctx.dispatched == want and sdmod.launches == 10 * want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
def test_fused_repeat_runs_ahead_bitwise(cuda, fused_torus, d):
    """A warm fused repeat with the same LHS object solves while the pool
    compares: one launch and one host wait, and the answer bit for bit
    the call's before it, which compared first."""
    V, S, M, neigh, noise = fused_torus
    solver = _fused_solver(V, M, neigh, torch.float32)
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ (noise[:, 0] if d == 1 else noise)
    solver.solve(lhs, rhs, mode="fused")                 # builds, captures
    x = solver.solve(lhs, rhs, mode="fused")             # compares, replays
    assert solver.solver_timing["facade_ran_ahead"] == 0.0
    for _ in range(2):
        y = solver.solve(lhs, rhs, mode="fused")
        t = solver.solver_timing
        assert t["facade_ran_ahead"] == 1.0 and t["facade_discarded"] == 0.0
        assert t["graph_launches"] == 1 and t["host_reads"] == 1
        assert t["facade_compare_wait"] >= 0
        assert np.array_equal(y, x)


@pytest.mark.cuda
def test_fused_graph_recaptured_after_update_lhs(cuda, fused_torus):
    V, S, M, neigh, noise = fused_torus
    solver = _fused_solver(V, M, neigh, torch.float32)
    rhs = M @ noise[:, 0]
    lhs = (M + 1e-3 * S).tocsr()
    ctx = solver._context(lhs)
    x_old = ctx.solve(rhs, mode="fused")[0]
    loop = next(iter(ctx._fused.values()))
    lhs2 = (M + 1e-2 * S).tocsr()
    assert solver._context(lhs2) is ctx and ctx._fused == {}   # update_lhs
    assert loop.graph.graph is None and loop.graph._loop is None   # released
    traced = ctx.solve(rhs, mode="traced")
    fused = ctx.solve(rhs, mode="fused")
    assert np.array_equal(fused[0], traced[0]) and fused[1] == traced[1]
    assert ctx.timing["graph_captures"] == 1 and ctx.timing["graph_launches"] == 1
    assert solver.residual(lhs2, rhs, fused[0]) <= 1e-4
    assert np.linalg.norm(fused[0] - x_old) > 1e-2 * np.linalg.norm(x_old)


@pytest.mark.cuda
def test_fused_graph_memory_flat_over_update_lhs(cuda, fused_torus):
    """Ten rounds of ``update_lhs`` and a fused solve: each round captures
    and builds anew, and the device memory reserved does not grow by the
    graph pool each round (the released pools go back to the device)."""
    V, S, M, neigh, noise = fused_torus
    solver = _fused_solver(V, M, neigh, torch.float32)
    rhs = M @ noise[:, 0]
    reserved, pools = [], []
    for k in range(10):
        lhs = (M + (1e-3 + 1e-3 * k) * S).tocsr()
        ctx = solver._context(lhs)
        traced = ctx.solve(rhs, mode="traced")
        fused = ctx.solve(rhs, mode="fused")
        assert np.array_equal(fused[0], traced[0]) and fused[1] == traced[1]
        assert ctx.timing["graph_captures"] == 1
        torch.cuda.synchronize()
        reserved.append(torch.cuda.memory_reserved())
        pools.append(ctx.timing["graph_pool_mib"] * 2**20)
    assert len(solver._contexts) == 1 and min(pools) > 0
    # a pool kept per round would add 8 pools from round 2 to round 10
    assert reserved[-1] - reserved[1] < 2 * max(pools), (reserved, pools)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 1), (torch.float64, 3)])
def test_epilogue_cycle_and_fused_solve_match_plain_compositions(
        cuda, fused_torus, dtype, d):
    """65k torus: one V-cycle and a fused solve with the epilogue launches
    against the same with the plain compositions patched in: iterate,
    cycles and trace bitwise equal; the same SpMV launch counts (10 of
    sliced_diag_spmv a cycle), now carried by the epilogues (8 Chebyshev
    steps and 2 residuals on A0, a prolongation add per level), and fewer
    kernels in the captured cycle.  The plain compositions are the ones
    chip_smoke.py patches in for its own comparison."""
    from chip_smoke import plain_compositions
    from gravo_mg_tpu_torch.solver import multigrid as mg

    V, S, M, neigh, noise = fused_torus
    lhs = (1e-6 * M + S).tocsr()
    rhs = M @ (noise[:, 0] if d == 1 else noise)
    ctx = _fused_solver(V, M, neigh, dtype)._context(lhs)
    b = torch.from_numpy(rhs).to(cuda, dtype)
    x0 = torch.from_numpy(1e-3 * noise[:, :d].reshape(b.shape)).to(cuda, dtype)
    runs = {}
    for how in ("epilogues", "plain"):
        ctx.release_graphs()
        with plain_compositions() if how == "plain" else contextlib.nullcontext():
            x1 = mg.cycle_step(ctx.cfg, ctx.levels, ctx.coarse_op, b, x0)
            ctx.solve(rhs, mode="fused")                 # cold: captures
            _reset_launches()
            x, iters, res, trace = ctx.solve(rhs, mode="fused")
            (loop,) = ctx._fused.values()
            runs[how] = (x1, x, iters, res, [r for _, r in trace], ctx.dispatched,
                         sdmod.launches, slmod.launches, dict(sdmod.launches_by_mode),
                         dict(slmod.launches_by_mode), loop.graph.step_nodes["kernel"])
    (x1, x, iters, res, trace, ran, n_sd, n_sl, sd_modes, sl_modes, nodes) = \
        runs["epilogues"]
    p = runs["plain"]
    assert torch.equal(x1, p[0])
    assert np.array_equal(x, p[1]) and iters == p[2] and res == p[3] and trace == p[4]
    assert ran == p[5] == iters > 1 and (n_sd, n_sl) == (p[6], p[7])
    assert n_sd == 10 * ran
    assert sd_modes == {"plain": 0, "residual": 2 * ran, "cheb": 8 * ran}
    assert p[8] == {"plain": 10 * ran, "residual": 0, "cheb": 0}
    levels = len(ctx.levels)
    assert sl_modes["add"] == levels * ran
    assert sl_modes["cheb"] == 8 * (levels - 1) * ran
    assert sl_modes["residual"] == (levels - 1) * ran
    assert nodes < p[10], (nodes, p[10])
    traced = ctx.solve(rhs, mode="traced")      # the host loop agrees
    assert np.array_equal(traced[0], x) and traced[1] == iters
    ctx.release_graphs()


@pytest.mark.cuda
@pytest.mark.parametrize("poisson,max_iter", [(True, 100), (False, 2000)])
def test_cg_graph_matches_eager_unit(cuda, fused_torus, poisson, max_iter,
                                     monkeypatch):
    """CG's 32-iteration unit replayed from its graph, captured in this
    solve and kept in a cache for the next, against the same unit run
    eagerly on the card: equal iterations and x.  Poisson at tol 1e-10
    stops at max_iter = 100 (three units and 4 eager iterations)."""
    from gravo_mg_tpu_torch.solver import device_loop, direct

    V, S, M, neigh, noise = fused_torus
    lhs = (1e-6 * M + S).tocsr() if poisson else (M + 1e-3 * S).tocsr()
    rhs = M @ noise[:, 0]
    tol = 1e-10 if poisson else 1e-4
    runs = []
    cache = {}
    for run in ("graph", "cached", "eager"):
        if run == "eager":
            class EagerUnit(device_loop.StepGraph):
                def run(self, n):
                    for _ in range(n):
                        self.step()
            monkeypatch.setattr(direct, "StepGraph", EagerUnit)
        timing = {}
        x = direct.cg_solve(lhs, rhs, tol=tol, max_iter=max_iter, device=cuda,
                            timing=timing, cache=cache if run != "eager" else None)
        runs.append((x, timing))
    (x, t), (x_cached, t_cached), (x_eager, t_eager) = runs
    units = t["cg_iterations"] // 32
    assert t["cg_iterations"] == t_cached["cg_iterations"] == t_eager["cg_iterations"]
    assert (t["cg_iterations"] == max_iter) == poisson
    # the first solve runs its first unit eagerly; the cached one replays all
    assert t["cg_graph_replays"] == units - 1 > 0 and t["cg_capture_ms"] > 0
    assert t_cached["cg_graph_replays"] == units and t_cached["cg_capture_ms"] == 0
    assert t_eager["cg_graph_replays"] == 0
    assert np.isfinite(x).all() and np.array_equal(x, x_eager)
    assert np.array_equal(x_cached, x_eager)


# ---- the halo solver's device loop: the halo cycle under the WHILE node ----

def _halo_solver(V, M, neigh):
    # the gate of 16 row groups: the stacked interiors of A0 and A1 (4
    # partitions of a 1024-row stride) are SlicedDiag
    return MultigridSolver(V, neigh, M, lower_bound=200, device="cuda",
                           diag_min_groups=16)


def _halo_fused_against_traced(hctx, rhs, solves=3):
    """``solves`` fused solves of ``rhs`` against one traced solve: the
    same iterate bit for bit, cycles and residual; one capture and one
    WHILE graph in all; one launch per solve, one host wait per warm
    solve (two on the cold one); each wrapper's launches per cycle the
    card ran equal the host loop's per cycle."""
    _reset_launches()
    traced = hctx.solve(rhs, tol=1e-5, max_iter=50, mode="traced")
    assert hctx.dispatched == traced[1]
    per_cycle = [m.launches // traced[1] for m in (sdmod, slmod, hmod)]
    assert [m.launches for m in (sdmod, slmod, hmod)] == [k * traced[1] for k in per_cycle]
    assert min(per_cycle) > 0
    for solve in range(solves):
        _reset_launches()
        fused = hctx.solve(rhs, tol=1e-5, max_iter=50)
        assert fused[1] == traced[1] and fused[2] == traced[2]
        assert np.array_equal(fused[0], traced[0])
        t = hctx.timing
        assert t["graph_captures"] == 1 and t["graph_launches"] == 1
        assert t["host_reads"] == (2 if solve == 0 else 1)
        assert hctx.dispatched == fused[1]
        assert ([m.launches for m in (sdmod, slmod, hmod)]
                == [k * hctx.dispatched for k in per_cycle])
        assert dmod.launches == smod.launches == 0
    assert len(hctx._fused) == 1
    return fused


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
def test_halo_fused_graph_matches_traced_bitwise(cuda, halo_torus, d):
    """Four partitions in one process (no process group): the captured
    halo cycle against the host loop, then ``release_graphs``."""
    from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh

    V, M, neigh, lhs = halo_torus
    rhs = M @ np.random.default_rng(d).standard_normal((len(V), d))
    rhs = rhs[:, 0] if d == 1 else rhs
    solver = _halo_solver(V, M, neigh)
    hctx = HaloContext(solver._context(lhs), make_solver_mesh(4, cuda))
    x, _, res = _halo_fused_against_traced(hctx, rhs)
    assert res <= 1e-5 and solver.residual(lhs, rhs, x) <= 2e-5
    loop = next(iter(hctx._fused.values()))
    hctx.release_graphs()
    assert hctx._fused == {} and loop.graph.graph is None and loop.graph._loop is None


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_partitioned_operations_on_cuda_match_plain_composition(cuda, halo_torus,
                                                                 dtype, d):
    """The halo path's level-0 operations on the card (4 partitions; A0's
    stacked interior SlicedDiag, U0's SlicedEll): each Chebyshev step,
    Jacobi step and residual of A0 and the add of U0 is two launches (the
    masked interior, then halo_spmv in the same mode) and equals the plain
    composition over the partitioned apply bit for bit."""
    from gravo_mg_tpu_torch.ops.epilogue import epilogue_plain
    from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh

    V, M, neigh, lhs = halo_torus
    solver = MultigridSolver(V, neigh, M, lower_bound=200, dtype=dtype, device=cuda,
                             diag_min_groups=16)
    hctx = HaloContext(solver._context(lhs), make_solver_mesh(4, cuda))
    A, U = hctx.levels[0].A, hctx.levels[0].U.U
    assert isinstance(A.A, sparse.SlicedDiag) and isinstance(U.A, sparse.SlicedEll)
    n = A.A.nrows
    for op in EPILOGUE_OPS:
        pop = U if op == "add" else A
        mod = slmod if op == "add" else sdmod
        kw, mode = _epilogue_case(op, n, n, d, dtype, cuda)
        x = _x(pop.A.ncols if op == "add" else n, d, dtype, 3, cuda)
        y = pop(x)
        _reset_launches()
        if mode == "cheb":
            keep = op != "jacobi"
            d_in = None if kw["d"] is None else kw["d"].clone()
            got = pop.cheb(kw["dinv"], kw["b"], x, d_in, kw["c1"], kw["c2"], keep)
            want = epilogue_plain("cheb", y, x=x, keep_d=keep, **kw)
            assert torch.equal(got[0], want[0])
            assert (got[1] is None) == (want[1] is None)
            if keep:
                assert torch.equal(got[1], want[1])
        elif mode == "residual":
            assert torch.equal(pop.residual(x, kw["b"]),
                               epilogue_plain("residual", y, **kw))
        else:
            assert torch.equal(pop.add(x, kw["z"]), epilogue_plain("add", y, **kw))
        torch.cuda.synchronize()
        assert mod.launches_by_mode[mode] == mod.launches == 1
        assert hmod.launches_by_mode[mode] == hmod.launches == 1


@pytest.mark.cuda
def test_halo_fused_solve_matches_plain_compositions(cuda, halo_torus):
    """Four partitions in one process: the fused halo solve through the
    epilogue launches against the same solve with the plain compositions
    patched in (chip_smoke.plain_compositions) and against the traced
    solve: x, cycles, residual and the loop's trace bit for bit;
    halo_spmv in every mode, and fewer kernels in the captured cycle."""
    from chip_smoke import plain_compositions
    from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh

    V, M, neigh, lhs = halo_torus
    rhs = M @ np.random.default_rng(5).standard_normal(len(V))
    hctx = HaloContext(_halo_solver(V, M, neigh)._context(lhs),
                       make_solver_mesh(4, cuda))
    runs = {}
    for how in ("epilogues", "plain"):
        hctx.release_graphs()
        with plain_compositions() if how == "plain" else contextlib.nullcontext():
            hctx.solve(rhs, tol=1e-5, max_iter=50)            # cold: captures
            _reset_launches()
            x, iters, res = hctx.solve(rhs, tol=1e-5, max_iter=50)
            (loop,) = hctx._fused.values()
            runs[how] = (x, iters, res, loop.state.trace[:iters].tolist(),
                         dict(hmod.launches_by_mode), loop.graph.step_nodes["kernel"])
    e, p = runs["epilogues"], runs["plain"]
    assert np.array_equal(e[0], p[0]) and e[1:4] == p[1:4] and e[1] > 1
    assert all(e[4][m] > 0 for m in ("residual", "add", "cheb"))
    assert p[4]["plain"] > 0 and p[4]["residual"] == p[4]["add"] == p[4]["cheb"] == 0
    assert e[5] < p[5], (e[5], p[5])
    traced = hctx.solve(rhs, tol=1e-5, max_iter=50, mode="traced")
    assert np.array_equal(traced[0], e[0]) and traced[1:] == e[1:3]
    hctx.release_graphs()


@pytest.mark.cuda
def test_halo_fused_graph_on_one_rank_nccl_group(cuda, halo_torus, tmp_path,
                                                 monkeypatch):
    """A one-rank NCCL group holding four partitions: the coarse solve's
    all-gather and the residual's all-reduce are NCCL calls inside the
    captured cycle, which runs inside the conditional WHILE node."""
    import torch.distributed as dist

    from gravo_mg_tpu_torch.parallel import multihost
    from gravo_mg_tpu_torch.parallel.halo import HaloContext

    monkeypatch.setenv("NCCL_SOCKET_IFNAME", "lo")
    multihost.initialize(init_method=f"file://{tmp_path / 'rendezvous'}",
                         world_size=1, rank=0, backend="nccl")
    try:
        V, M, neigh, lhs = halo_torus
        rhs = M @ np.random.default_rng(5).standard_normal(len(V))
        solver = _halo_solver(V, M, neigh)
        mesh = multihost.global_row_mesh(4, "cuda")
        assert mesh.distributed
        hctx = HaloContext(solver._context(lhs), mesh)
        x, _, res = _halo_fused_against_traced(hctx, rhs)
        assert res <= 1e-5 and solver.residual(lhs, rhs, x) <= 2e-5
    finally:
        dist.destroy_process_group()


def _nccl_halo_worker(rank: int, world: int, init_file: str) -> None:
    """One rank of ``test_halo_fused_on_two_nccl_ranks`` (its own GPU, two
    partitions): fused against traced bit for bit, then against the same
    four partitions held by one process."""
    import torch.distributed as dist

    from gravo_mg_tpu_torch.parallel import multihost
    from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh

    multihost.initialize(init_method=f"file://{init_file}", world_size=world,
                         rank=rank, backend="nccl")
    V, F, S, M, neigh = _torus(128, 96)
    lhs = (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(5).standard_normal(len(V))
    solver = _halo_solver(V, M, neigh)
    mesh = multihost.global_row_mesh(2, "cuda")
    hctx = HaloContext(solver._context(lhs), mesh)
    remote = sum(len(op.sends) + len(op.recvs)
                 for lvl in hctx.levels for op in (lvl.A, lvl.U.U, lvl.U.UT))
    assert remote > 0, remote
    x, iters, res = _halo_fused_against_traced(hctx, rhs)
    x1, it1, _ = HaloContext(solver._context(lhs),
                             make_solver_mesh(4, "cuda")).solve(rhs, tol=1e-5,
                                                                max_iter=50)
    rel = np.abs(x - x1).max() / np.abs(x1).max()
    print(f"r{rank}: iters {iters} (one rank {it1}) res {res:.3e} rel {rel:.3e} "
          f"bitwise {np.array_equal(x, x1)} remote transfers {remote}", flush=True)
    assert iters == it1 and rel < 1e-4 and res <= 1e-5
    dist.destroy_process_group()
    print(f"r{rank}: NCCL_HALO_OK", flush=True)


@pytest.mark.cuda
def test_halo_fused_on_two_nccl_ranks(cuda, tmp_path):
    """Two processes, one GPU and two partitions each: the first capture of
    NCCL point-to-point transfers (``batch_isend_irecv``) in the halo
    cycle.  Skips with fewer than two GPUs."""
    import os
    import subprocess
    import sys

    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs 2 GPUs; {torch.cuda.device_count()} present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo",
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    init = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "nccl-halo-worker", str(r),
         "2", init], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(2)]
    outs = []
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "NCCL_HALO_OK" in out, f"rank {r}:\n{out[-4000:]}"


@pytest.mark.cuda
def test_halo_fused_step_that_syncs_raises(cuda, halo_torus, monkeypatch):
    """A halo cycle that makes the host wait cannot be captured: the solve
    raises, and no host loop takes over."""
    from gravo_mg_tpu_torch.parallel.halo import HaloContext, make_solver_mesh
    from gravo_mg_tpu_torch.solver import multigrid as mg

    V, M, neigh, lhs = halo_torus
    hctx = HaloContext(_halo_solver(V, M, neigh)._context(lhs),
                       make_solver_mesh(4, cuda))
    plain = mg.cycle_step

    def syncing_cycle(*args):
        out = plain(*args)
        out.sum().item()
        return out

    rhs = M @ np.random.default_rng(5).standard_normal(len(V))
    _reset_launches()
    hctx.solve(rhs, tol=1e-5, max_iter=1, mode="traced")
    per_cycle = sdmod.launches
    monkeypatch.setattr(mg, "cycle_step", syncing_cycle)
    _reset_launches()
    with pytest.raises(RuntimeError, match="capturing the step failed"):
        hctx.solve(rhs, tol=1e-5, max_iter=50)
    # the warm-up cycle ran; the failed capture's launches were taken back
    assert sdmod.launches == per_cycle > 0


@pytest.mark.cuda
def test_step_graph_finalized_during_a_capture_waits_for_it(cuda):
    """A StepGraph whose last reference goes while another step is being
    captured (the cyclic garbage collector may run at any allocation) keeps
    its graph until that capture ends, and is released then: destroying a
    graph inside a capture would invalidate the capture."""
    import gc

    from gravo_mg_tpu_torch.solver import device_loop

    x = torch.ones(1000, device=cuda)
    y = torch.zeros_like(x)
    old = [device_loop.StepGraph(lambda: y.add_(x), cuda)]
    old[0].run(3)                       # an eager step, a capture, 2 replays
    assert old[0].graph is not None
    calls = []

    def step():
        calls.append(1)
        y.mul_(0.5)
        if len(calls) == 2:             # the capture: drop the old graph here
            old.clear()
            gc.collect()

    g = device_loop.StepGraph(step, cuda)
    g.run(3)
    torch.cuda.synchronize()
    assert not old and device_loop._DEFERRED == []
    assert g.captures == 1 and g.replays == 2
    assert torch.equal(y, torch.full_like(x, 3.0 * 0.125))


@pytest.mark.cuda
def test_fused_step_that_syncs_raises(cuda, fused_torus, monkeypatch):
    """A step that makes the host wait for the card cannot be captured: the
    solve raises, and no eager loop takes over.  Last in the file: a
    failed capture is the one thing here that touches the CUDA context's
    error state."""
    from gravo_mg_tpu_torch.solver import device_loop
    from gravo_mg_tpu_torch.solver import multigrid as mg

    x = torch.ones(1000, device=cuda)
    steps = []

    def syncing():
        steps.append(float(x.sum()))

    g = device_loop.StepGraph(syncing, cuda)
    with pytest.raises(RuntimeError, match="capturing the step failed"):
        g.run(2)
    assert steps == [1000.0] and g.graph is None and g.replays == 0

    V, S, M, neigh, noise = fused_torus
    solver = _fused_solver(V, M, neigh, torch.float32)
    lhs = (M + 1e-3 * S).tocsr()
    ctx = solver._context(lhs)
    plain = mg.cycle_step

    def syncing_cycle(*args):
        out = plain(*args)
        out.sum().item()
        return out

    monkeypatch.setattr(mg, "cycle_step", syncing_cycle)
    _reset_launches()
    with pytest.raises(RuntimeError, match="capturing the step failed"):
        ctx.solve(M @ noise[:, 0], mode="fused")
    # the warm-up cycle ran; the failed capture's launches were taken back
    assert sdmod.launches == 10


if __name__ == "__main__":
    import sys

    if sys.argv[1] == "nccl-halo-worker":
        _nccl_halo_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
