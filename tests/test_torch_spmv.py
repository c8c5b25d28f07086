"""The plain PyTorch SpMVs (the CPU side of ops/shuffle_spmv.py and
ops/diag_spmv.py) against the JAX package's on the same layouts.

Layouts are built once by the reference from numpy-seeded COO triplets
with duplicate entries (each duplicate takes its own slot), carried over
with convert.py, and applied to the same x in both packages.
Tolerances: rtol 1e-5 in f32 and 1e-12 in f64, relative to the largest
output entry (summation order differs between the two packages).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu import sparse as ref_sparse
from gravo_mg_tpu.ops.diag_spmv import _diag_spmv_pallas, _diag_spmv_xla
from gravo_mg_tpu_torch import convert, sparse
from gravo_mg_tpu_torch.ops.diag_spmv import diag_spmv_plain
from gravo_mg_tpu_torch.ops.shuffle_spmv import shuffle_spmv_plain

torch.set_num_threads(2)

RTOL = {np.float32: 1e-5, np.float64: 1e-12}

MATRICES = [
    # (n, m, nnz, half-bandwidth or None for fully random, seed)
    (1000, 1000, 7000, 30, 0),
    (5000, 5000, 45000, 400, 1),
    (3000, 3000, 6000, None, 2),
    (2000, 300, 8000, 20, 3),      # restriction-shaped
    (300, 2000, 2400, 40, 4),      # prolongation-shaped
    (130, 130, 400, None, 5),      # under two row groups
]


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
    v = np.zeros((kp * s * 128,), dtype)
    r[pos] = (cols & 127).astype(np.int8)
    v[pos] = vals
    return r.reshape(kp, s, 128), v.reshape(kp, s, 128)


def _x(m, d, dtype, seed):
    rng = np.random.default_rng(seed + 100)
    x = rng.standard_normal((m,) if d == 1 else (m, d))
    return x.astype(dtype)


def _close(got, ref, dtype):
    ref = np.asarray(ref)
    atol = RTOL[dtype] * max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=atol)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,m,nnz,bw,seed", MATRICES)
def test_shuffle_plain_matches_reference(n, m, nnz, bw, seed, dtype, d):
    rows, cols, vals = _coo(n, m, nnz, bw, seed)
    kp, s, q, pos = ref_sparse._shuffle_layout(rows, cols, n, m)
    r, v = _fill(kp, s, pos, cols, vals, dtype)
    ref_op = ref_sparse.ShuffleEll(jnp.asarray(q), jnp.asarray(r),
                                   jnp.asarray(v), n, m)
    x = _x(m, d, dtype, seed)
    ref = ref_sparse.shuffle_spmv(ref_op, jnp.asarray(x))
    op = convert.operator_from_reference(ref_op)
    got = sparse.spmv(op, torch.from_numpy(x))
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == ref.shape
    _close(got, ref, dtype)
    # the plain version is the COO sum of the triplets, duplicates included
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, m)).tocsr()
    _close(shuffle_spmv_plain(op.q, op.r, op.v, torch.from_numpy(x), n),
           A @ x.astype(np.float64), dtype)


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("tg", [32, 128])
@pytest.mark.parametrize("n,m,nnz,bw,seed", [
    mm for mm in MATRICES if mm[0] == mm[1]
])
def test_diag_plain_matches_reference_xla(n, m, nnz, bw, seed, tg, d):
    dtype = np.float32
    rows, cols, vals = _coo(n, m, nnz, bw, seed)
    kp, s_pad, tg, start, pos = ref_sparse._diag_layout(rows, cols, n, m, tg=tg)
    r, v = _fill(kp, s_pad, pos, cols, vals, dtype)
    x = _x(m, d, dtype, seed)
    nb = -(-m // 128)
    xb = np.zeros((nb * 128, d), dtype)
    xb[:m] = x.reshape(m, d)
    ref = np.stack([
        np.asarray(_diag_spmv_xla(jnp.asarray(start),
                                  jnp.asarray(xb[:, j].reshape(nb, 128)),
                                  jnp.asarray(r), jnp.asarray(v), tg)).reshape(-1)[:n]
        for j in range(d)
    ], axis=1)
    ref = ref[:, 0] if d == 1 else ref
    got = diag_spmv_plain(torch.from_numpy(start), torch.from_numpy(r),
                          torch.from_numpy(v), torch.from_numpy(x), tg, n)
    _close(got, ref, dtype)
    D = ref_sparse.DiagEll(jnp.asarray(start), jnp.asarray(r), jnp.asarray(v),
                           tg, n, m)
    _close(sparse.spmv(convert.operator_from_reference(D), torch.from_numpy(x)),
           ref, dtype)


def test_diag_plain_matches_reference_pallas_interpret():
    """Against the Pallas slice-DMA kernel itself, in TPU interpret mode
    at its production tile (tg = 512, one full tile of 512 groups)."""
    from jax.experimental.pallas import tpu as pltpu

    tg = 512
    n = tg * 128
    rows, cols, vals = _coo(n, n, 3 * n, 200, 7)
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n))
    A.sum_duplicates()
    kp, s_pad, _, start, pos = ref_sparse._diag_layout(
        np.asarray(A.row, np.int64), np.asarray(A.col, np.int64), n, n, tg=tg
    )
    r, v = _fill(kp, s_pad, pos, np.asarray(A.col, np.int64), A.data, np.float32)
    x = _x(n, 1, np.float32, 7)
    xp = np.zeros(((n // 128 + 2 * tg) * 128,), np.float32)
    xp[tg * 128: tg * 128 + n] = x
    with pltpu.force_tpu_interpret_mode():
        ref = _diag_spmv_pallas(jnp.asarray(start), jnp.asarray(xp.reshape(-1, 128)),
                                jnp.asarray(r), jnp.asarray(v), tg)
    got = diag_spmv_plain(torch.from_numpy(start), torch.from_numpy(r),
                          torch.from_numpy(v), torch.from_numpy(x), tg, n)
    _close(got, np.asarray(ref).reshape(-1)[:n], np.float32)


def test_cuda_wrappers_refuse_non_cpu_devices_without_fallback():
    """A wrapper takes the plain version only for CPU tensors; anything
    else goes to the kernel path, which validates and never falls back."""
    from gravo_mg_tpu_torch.ops import diag_spmv as dmod
    from gravo_mg_tpu_torch.ops import shuffle_spmv as smod

    x = torch.zeros(4, device="meta")
    q = torch.zeros((4, 8), dtype=torch.int32)
    r = torch.zeros((4, 8, 128), dtype=torch.int8)
    v = torch.zeros((4, 8, 128))
    with pytest.raises(ValueError, match="unsupported device"):
        smod.shuffle_spmv(q, r, v, x, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        dmod.diag_spmv(torch.zeros((1, 4), dtype=torch.int32), r, v, x, 8, 4)
