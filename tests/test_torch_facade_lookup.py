"""The facade's context lookup: a caller's CSR matrix is compared byte for
byte with the facade's own copies of each context's ``indptr``,
``indices`` and ``data``.

On the CPU, in both loop modes: one LHS object reused keeps one context
and compares one stored pattern; an edit of ``lhs.data`` in place is seen
(the answer is the edited system's); two patterns of one shape and nnz
keep two contexts; COO and int64-index inputs find right answers; a fifth
pattern evicts the oldest context and releases its graphs.  The compare
split over threads sees a change in every part.  On the card
(marked ``cuda``, skipped without a GPU): the edit in place releases the
captured WHILE graph and the next fused solve runs the new values.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from gravo_mg_tpu_torch import MultigridSolver, core
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_voronoi
from gravo_mg_tpu_torch.utils.meshgen import icosphere
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

torch.set_num_threads(2)

MODES = ["traced", "fused"]


@pytest.fixture(scope="module")
def sphere():
    V, F = icosphere(3, bump=0.1)
    S, M = cotan_laplacian(V, F), mass_voronoi(V, F)
    return V, F, S, M, neighbors_from_faces(F)


def _solver(sphere, device="cpu"):
    V, F, S, M, neigh = sphere
    return MultigridSolver(V, neigh, M, lower_bound=100, dtype=torch.float64,
                           device=device)


def _fresh(sphere, lhs, rhs, mode):
    """A new solver's answer: the reference for the facade's reuse."""
    return _solver(sphere).solve(lhs, rhs, mode=mode)


def _close(x, ref):
    return np.linalg.norm(x - ref) <= 1e-10 * np.linalg.norm(ref)


def _with_zeros(A, pairs):
    """``A`` with explicit zeros stored at ``(i, j)`` and ``(j, i)`` for
    each pair: the same matrix under another pattern."""
    A = A.tocoo()
    i, j = np.array(pairs).T
    rows, cols = np.r_[A.row, i, j], np.r_[A.col, j, i]
    out = sp.csr_matrix((np.r_[A.data, np.zeros(2 * len(i))], (rows, cols)),
                        shape=A.shape)
    assert out.nnz == A.nnz + 2 * len(i)
    return out


def _absent_pairs(A, k):
    """``k`` symmetric positions off ``A``'s pattern."""
    A, n = A.tocsr(), A.shape[0]
    pairs = [(i, n - 1 - i) for i in range(n // 2) if A[i, n - 1 - i] == 0]
    assert len(pairs) >= k
    return pairs[:k]


def _same_object(sphere, mode, monkeypatch):
    V, F, S, M, neigh = sphere
    solver, lhs, rhs = _solver(sphere), (M + 1e-3 * S).tocsr(), M @ V
    solver.solve(lhs, rhs, mode=mode)
    ctx = next(iter(solver._contexts.values()))
    first = dict(solver.solver_timing)
    updates = []
    monkeypatch.setattr(ctx, "update_lhs", updates.append)
    for _ in range(2):
        x = solver.solve(lhs, rhs, mode=mode)
        t = solver.solver_timing
        assert list(solver._contexts.values()) == [ctx] and updates == []
        assert t["facade_patterns_compared"] == 1
        # no set-up ran: plan_build is the first call's, outside the total
        assert t["plan_build"] == first["plan_build"]
        assert t["solver_total"] == pytest.approx(
            t["solve_upload"] + t["cycles"] + t["solve_copy_back"])
    assert first["facade_patterns_compared"] == 0
    assert _close(x, _fresh(sphere, lhs, rhs, mode))


def _data_edited_in_place(sphere, mode, monkeypatch):
    V, F, S, M, neigh = sphere
    solver, lhs, rhs = _solver(sphere), (M + 1e-3 * S).tocsr(), M @ V
    x_old = solver.solve(lhs, rhs, mode=mode)
    lhs.data *= 2
    x = solver.solve(lhs, rhs, mode=mode)
    assert len(solver._contexts) == 1
    assert solver.solver_timing["facade_patterns_compared"] == 1
    assert _close(x, _fresh(sphere, lhs, rhs, mode))
    assert not _close(x, x_old)
    # the owned copy took the edit: the next call compares equal
    ctx = next(iter(solver._contexts.values()))
    monkeypatch.setattr(ctx, "update_lhs", pytest.fail)
    assert _close(solver.solve(lhs, rhs, mode=mode), x)


def _two_patterns_one_nnz(sphere, mode, monkeypatch):
    V, F, S, M, neigh = sphere
    A, rhs = (M + 1e-3 * S).tocsr(), M @ V
    p, q = _absent_pairs(A, 2)
    A1, A2 = _with_zeros(A, [p]), _with_zeros(A, [q])
    assert A1.shape == A2.shape and A1.nnz == A2.nnz
    solver, ref = _solver(sphere), _fresh(sphere, A, rhs, mode)
    for lhs, compared, contexts in ((A1, 0, 1), (A2, 1, 2), (A1, 2, 2), (A2, 2, 2)):
        x = solver.solve(lhs, rhs, mode=mode)
        assert solver.solver_timing["facade_patterns_compared"] == compared
        assert len(solver._contexts) == contexts
        assert _close(x, ref)
        assert solver.residual(lhs, rhs, x) <= solver.tolerance


def _coo_and_int64(sphere, mode, monkeypatch):
    V, F, S, M, neigh = sphere
    A, rhs = (M + 1e-3 * S).tocsr(), M @ V
    wide = A.copy()
    wide.indptr, wide.indices = A.indptr.astype(np.int64), A.indices.astype(np.int64)
    assert wide.indices.dtype == np.int64 and A.indices.dtype == np.int32
    solver, ref = _solver(sphere), _fresh(sphere, A, rhs, mode)
    for lhs, compared in ((A.tocoo(), 0), (A, 1), (wide, 0), (wide, 1), (A.tocoo(), 1)):
        x = solver.solve(lhs, rhs, mode=mode)
        assert solver.solver_timing["facade_patterns_compared"] == compared
        assert _close(x, ref)
    assert len(solver._contexts) == 2


def _lru_eviction(sphere, mode, monkeypatch):
    V, F, S, M, neigh = sphere
    A, rhs = (M + 1e-3 * S).tocsr(), M @ V
    pairs = _absent_pairs(A, 5)
    solver, ref = _solver(sphere), _fresh(sphere, A, rhs, mode)
    assert solver._CONTEXT_LRU == 4
    order = []
    for k, pair in enumerate(pairs):
        x = solver.solve(_with_zeros(A, [pair]), rhs, mode=mode)
        assert _close(x, ref)
        new = [c for c in solver._contexts.values() if c not in order]
        assert len(new) == 1 and next(reversed(solver._contexts.values())) is new[0]
        order.append(new[0])
        if k == 0:
            released = []
            monkeypatch.setattr(order[0], "release_graphs",
                                lambda: released.append(True))
    assert list(solver._contexts.values()) == order[1:] and released == [True]
    assert solver.solver_timing["facade_patterns_compared"] == 4


CASES = {
    "same_object": _same_object,
    "data_edited_in_place": _data_edited_in_place,
    "two_patterns_one_nnz": _two_patterns_one_nnz,
    "coo_and_int64": _coo_and_int64,
    "lru_eviction": _lru_eviction,
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("mode", MODES)
def test_facade_lookup(sphere, mode, case, monkeypatch):
    CASES[case](sphere, mode, monkeypatch)


@pytest.mark.parametrize("where", ["first", "middle", "last", "nowhere"])
def test_split_compare_sees_every_part(where, monkeypatch):
    monkeypatch.setattr(core, "_COMPARE_PARTS", 4)
    n = 4 * core._PART // 8 + 5            # f64: four parts, the last short
    own = np.arange(n, dtype=np.float64)
    a = own.copy()
    pos = {"first": 0, "middle": n // 2, "last": n - 1}.get(where)
    if pos is not None:
        a[pos] = -1.0
    with ThreadPoolExecutor(3) as pool:
        assert core._same_bytes(a, own, pool) == (pos is None)
        # a strided view is compared by its contents
        assert core._same_bytes(np.repeat(a, 2)[::2], own, pool) == (pos is None)


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_edit_in_place_releases_the_while_graph(cuda, sphere):
    V, F, S, M, neigh = sphere
    solver, lhs, rhs = _solver(sphere, "cuda"), (M + 1e-3 * S).tocsr(), M @ V
    solver.solve(lhs, rhs, mode="fused")
    x_old = solver.solve(lhs, rhs, mode="fused")          # warm: replayed
    ctx = next(iter(solver._contexts.values()))
    loop = next(iter(ctx._fused.values()))
    lhs.data *= 2
    x = solver.solve(lhs, rhs, mode="fused")
    assert list(solver._contexts.values()) == [ctx]
    assert loop.graph.graph is None and loop.graph._loop is None   # released
    assert next(iter(ctx._fused.values())) is not loop             # captured anew
    assert solver.solver_timing["graph_captures"] == 1
    ref = _solver(sphere, "cuda").solve(lhs, rhs, mode="fused")
    assert _close(x, ref) and not _close(x, x_old)
    assert solver.residual(lhs, rhs, x) <= solver.tolerance
