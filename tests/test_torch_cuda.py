"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where
``torch.cuda.is_available()`` is false.  The file imports nothing of JAX,
so on a GPU machine without JAX it runs as

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: relative to the largest output entry, 1e-5 in f32 and 1e-12
in f64 (the kernel sums slots in ascending order, the plain version in
torch's reduction order).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu_torch import MultigridSolver, sparse
from gravo_mg_tpu_torch.ops import diag_spmv as dmod
from gravo_mg_tpu_torch.ops import shuffle_spmv as smod
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


@pytest.mark.cuda
def test_solve_on_cuda_goes_through_both_kernels(cuda):
    V, F = icosphere(4, bump=0.1)
    S, M, neigh = cotan_laplacian(V, F), mass_voronoi(V, F), neighbors_from_faces(F)
    lhs = (M + 1e-3 * S).tocsr()
    rhs = M @ V
    runs = {}
    for device in ("cpu", "cuda"):
        solver = MultigridSolver(V, neigh, M, lower_bound=100, device=device,
                                 diag_min_groups=16)
        smod.launches = dmod.launches = 0
        x = solver.solve(lhs, rhs)
        runs[device] = (solver.solver_timing["iterations"],
                        solver.residual(lhs, rhs, x),
                        smod.launches, dmod.launches)
    iters, res, n_shuffle, n_diag = runs["cuda"]
    assert iters == runs["cpu"][0]
    assert res <= 1e-4
    assert n_shuffle > 0 and n_diag > 0
    assert runs["cpu"][2:] == (0, 0)
