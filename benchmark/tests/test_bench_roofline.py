"""The format-neutral byte count against a hand count on a tiny mesh, and
the trace reduction on made-up events."""

import types

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import roofline, trace
from benchmark.reference.mesh import cotan_laplacian, mass_barycentric, torus_mesh


def _aggregation(n, groups):
    """Each fine vertex i prolongs from coarse vertex i % groups."""
    return sp.csr_matrix((np.ones(n), (np.arange(n), np.arange(n) % groups)),
                         shape=(n, groups))


@pytest.mark.parametrize("d,itemsize", [(1, 4), (3, 8)])
def test_cycle_bytes_match_a_hand_count(d, itemsize):
    V, F = torus_mesh(8, 6)
    n = V.shape[0]                       # 48
    M = mass_barycentric(V, F)
    A0 = (M + 1e-3 * cotan_laplacian(V, F)).tocsr()
    U = _aggregation(n, 12)
    chain, Us = roofline.galerkin_operators(A0, [U])
    nnz0 = np.count_nonzero(A0.toarray())      # exact zeros are no work
    nnz1 = np.count_nonzero((U.T @ abs(A0) @ U).toarray())
    assert chain[0].nnz == nnz0 and chain[1].nnz == nnz1
    assert Us[0].nnz == n
    per_cycle, per_solve = roofline.cycle_bytes(chain, Us, M, d, itemsize, 4, 4)
    s = itemsize
    a0 = nnz0 * (4 + s) + 2 * n * d * s
    u = n * (4 + s) + (n + 12) * d * s
    m = n * (4 + s) + 2 * n * d * s
    assert per_cycle == 9 * a0 + 2 * u + a0 + m
    assert per_solve == m


def test_cycle_bytes_count_only_the_v_cycle():
    with pytest.raises(ValueError):
        roofline.cycle_bytes([sp.eye(4).tocsr()], [], sp.eye(4).tocsr(), 1, 4,
                             4, 4, cycle_type=1)


def _event(name, start, end, device=False, thread=1):
    return types.SimpleNamespace(
        name=name, thread=thread,
        time_range=types.SimpleNamespace(start=start, end=end),
        device_type=types.SimpleNamespace(name="CUDA" if device else "CPU"))


def test_trace_reduction_reads_busy_idle_kernels_and_gaps():
    events = [
        _event("facade.solve", 0, 1000),
        _event("aten::copy_", 100, 300),
        _event("cudaStreamSynchronize", 600, 900),
        _event("void sliced_spmv_kernel<(Mode)0, float, 2, false>(long*)", 300, 400, True),
        _event("void sliced_spmv_kernel<(Mode)0, float, 2, false>(long*)", 380, 500, True),
        _event("Memcpy HtoD (Pageable -> Device)", 650, 700, True),
        _event("aten::add", 950, 2000),       # after the window: clipped
    ]
    p = trace.reduce_events(events, {"facade.solve"})
    assert p.window_s == pytest.approx(1000e-6)
    assert p.busy_s == pytest.approx(250e-6)
    assert p.idle_share == pytest.approx(0.75)
    assert p.kernels == 2
    assert p.spmv_s == pytest.approx(220e-6)
    assert p.device_ops[0] == ["sliced_spmv_kernel<(Mode)0, float, 2, false>",
                               pytest.approx(220e-6)]
    gaps = dict(p.idle_gaps)
    # gaps: 0-300, 500-650, 700-1000
    assert gaps["aten::copy_"] == pytest.approx(200e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(250e-6)
    assert gaps["facade.solve"] == pytest.approx(250e-6)
    assert gaps["aten::add"] == pytest.approx(50e-6)
    assert sum(gaps.values()) == pytest.approx(750e-6)


def test_trace_reduction_gives_nothing_without_device_events():
    assert trace.reduce_events([_event("facade.solve", 0, 10)],
                               {"facade.solve"}) is None
