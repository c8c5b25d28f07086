"""The port's device hierarchy engines against the JAX package without its
native library.

Every test switches the JAX package's native library off
(``gravo_mg_tpu.native._lib = False``), so the JAX package takes its
device path (Luby rounds, Bellman-Ford, batched weights); the port runs
its counterparts in torch with ``device="cpu"``.

Tolerances:
* Luby status after every round, samples, Bellman-Ford D, labels and
  rounds, coarse graphs: exactly equal.
* Prolongation weights (f32 geometry): U as sparse rows within 1e-5 on at
  least 99.9% of rows, every row summing to 1 within 1e-6, branch stats
  within 0.1% of N.
* Facade solves: the JAX cycle count, host residual <= 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import dijkstra

import gravo_mg_tpu.native
from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu.hierarchy import builder as ref_builder
from gravo_mg_tpu.hierarchy import cluster as ref_cluster
from gravo_mg_tpu.hierarchy import prolongation as ref_prolongation
from gravo_mg_tpu.hierarchy import sampling as ref_sampling
from gravo_mg_tpu.hierarchy import variants as ref_variants
from gravo_mg_tpu_torch import MultigridSolver, native
from gravo_mg_tpu_torch.enums import Sampling
from gravo_mg_tpu_torch.hierarchy import builder, cluster, prolongation, sampling, variants
from gravo_mg_tpu_torch.utils.meshgen import icosphere, torus_mesh
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces, neighbors_to_edges

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def jax_without_native(monkeypatch):
    monkeypatch.setattr(gravo_mg_tpu.native, "_lib", False)


@pytest.fixture(scope="module")
def plain_sphere():
    V, F = icosphere(4)
    return {"V": V, "neigh": neighbors_from_faces(F)}


@pytest.fixture(scope="module")
def torus96():
    V, F = torus_mesh(96, 96)
    return {"V": V, "neigh": neighbors_from_faces(F)}


def _graph(m):
    """(pos, neigh, f32 edge lengths, the hierarchy's radius cbrt(8) *
    mean edge)."""
    V, neigh = m["V"], m["neigh"]
    dist = sampling.edge_lengths_np(np.asarray(V, np.float64), neigh)
    return V, neigh, dist, 2.0 * float(dist[np.isfinite(dist)].mean())


def _u_rows_close(got, ref, n, frac=0.999, tol=1e-5):
    """U as sparse rows (duplicate columns summed): the share of rows whose
    entries agree within ``tol`` is at least ``frac``."""
    D = abs(got.tocsr() - ref.tocsr()).tocsr()
    bad = sum(1 for i in range(n)
              if D.indptr[i + 1] > D.indptr[i]
              and D.data[D.indptr[i]:D.indptr[i + 1]].max() > tol)
    assert bad <= (1 - frac) * n, f"{bad} of {n} rows differ by > {tol}"


def _csr(cols, w, nc):
    n = cols.shape[0]
    rows = np.repeat(np.arange(n), cols.shape[1])
    return sp.csr_matrix((w.ravel().astype(np.float64), (rows, cols.ravel())),
                         shape=(n, nc))


MESHES = ["sphere_mesh", "plain_sphere", "torus96"]


@pytest.mark.parametrize("two_ring", [True, False])
@pytest.mark.parametrize("mesh", MESHES)
def test_luby_round_matches_reference_every_round(mesh, two_ring, request):
    V, neigh, dist, r = _graph(request.getfixturevalue(mesh))
    n = V.shape[0]
    rank = np.random.default_rng(3).permutation(n).astype(np.int32)
    ref_status = jnp.zeros(n, jnp.int8)
    status = torch.zeros(n, dtype=torch.int8)
    nt, dt = sampling.graph_tensors(neigh, dist, CPU)
    for rounds in range(1, 50):
        ref_status, ref_und = ref_sampling._luby_round(
            ref_status, jnp.asarray(rank), jnp.asarray(neigh),
            jnp.asarray(dist), jnp.float32(r), two_ring=two_ring, block=1024)
        status, und = sampling._luby_round(
            status, torch.from_numpy(rank), nt, dt, float(np.float32(r)),
            two_ring=two_ring, block=1000)
        np.testing.assert_array_equal(status.numpy(), np.asarray(ref_status))
        assert int(und) == int(ref_und)
        if int(und) == 0:
            break
    assert 2 <= rounds < 50


@pytest.mark.parametrize("two_ring,max_rounds", [(True, 200), (False, 200), (True, 2)])
@pytest.mark.parametrize("mesh", ["sphere_mesh", "torus96"])
def test_parallel_disk_sample_luby_matches_reference(mesh, two_ring, max_rounds,
                                                     request):
    V, neigh, dist, r = _graph(request.getfixturevalue(mesh))
    ref_samples, ref_status = ref_sampling.parallel_disk_sample(
        V, neigh, r, two_ring=two_ring, seed=3, engine="luby",
        max_rounds=max_rounds)
    rounds = []
    samples, status = sampling.parallel_disk_sample(
        V, neigh, r, two_ring=two_ring, seed=3, engine="luby",
        max_rounds=max_rounds, device="cpu", rounds=rounds)
    np.testing.assert_array_equal(samples, ref_samples)
    np.testing.assert_array_equal(status, np.asarray(ref_status))
    assert samples.dtype == np.int32 and status.dtype == np.int8
    # the rounds the reference's loop ran (it stops at the first round
    # that leaves nothing undecided)
    ref_rounds, s = 0, jnp.zeros(V.shape[0], jnp.int8)
    rank = jnp.asarray(np.random.default_rng(3).permutation(V.shape[0]).astype(np.int32))
    for ref_rounds in range(1, max_rounds + 1):
        s, und = ref_sampling._luby_round(
            s, rank, jnp.asarray(neigh), jnp.asarray(dist), jnp.float32(r),
            two_ring=two_ring, block=65536)
        if int(und) == 0:
            break
    assert rounds == [ref_rounds]
    assert (max_rounds == 2) == bool((status == sampling.UNDECIDED).any())


def _conflict_ball(neigh, dist, s, r, two_ring):
    """Independent reference for the sampling conflict ball of s (as in
    tests/test_sampling.py)."""
    ball = set()
    for k, j in enumerate(neigh[s]):
        if j < 0 or dist[s, k] >= r:
            continue
        ball.add(int(j))
        if two_ring:
            for k2, m in enumerate(neigh[j]):
                if m < 0 or m == s:
                    continue
                if dist[s, k] + dist[j, k2] < r:
                    ball.add(int(m))
    return ball


@pytest.mark.parametrize("two_ring", [True, False])
def test_luby_separation_and_coverage(sphere_mesh, two_ring):
    """The invariants of tests/test_sampling.py for the port's Luby engine."""
    V, neigh = sphere_mesh["V"], sphere_mesh["neigh"]
    ii, jj = neighbors_to_edges(neigh)
    r = 2.0 * np.linalg.norm(V[ii] - V[jj], axis=1).mean()
    samples, status = sampling.parallel_disk_sample(
        V, neigh, r, two_ring=two_ring, seed=3, engine="luby", device="cpu")
    assert len(samples) > 10
    assert (status != sampling.UNDECIDED).all()
    safe = np.maximum(neigh, 0)
    dist = np.linalg.norm(V[safe] - V[:, None, :], axis=-1)
    dist[neigh < 0] = np.inf
    sample_set = set(samples.tolist())
    covered = set(samples.tolist())
    for s in samples:
        ball = _conflict_ball(neigh, dist, int(s), r, two_ring)
        assert not (ball & sample_set), f"samples too close around {s}"
        covered |= ball
    assert covered == set(range(V.shape[0]))


@pytest.mark.parametrize("max_rounds", [2, 256])
@pytest.mark.parametrize("mesh", ["sphere_mesh", "torus96"])
def test_bellman_ford_matches_reference(mesh, max_rounds, request):
    V, neigh, dist, r = _graph(request.getfixturevalue(mesh))
    n = V.shape[0]
    samples, _ = ref_sampling.parallel_disk_sample(V, neigh, r, seed=3,
                                                   engine="luby")
    D0 = np.full(n, np.inf, np.float32)
    D0[samples] = 0.0
    L0 = np.zeros(n, np.int32)
    L0[samples] = np.arange(len(samples), dtype=np.int32)
    ref_D, ref_L, ref_rounds = ref_cluster._bellman_ford(
        jnp.asarray(D0), jnp.asarray(L0), jnp.asarray(neigh),
        jnp.asarray(dist), max_rounds=max_rounds)
    nt, dt = sampling.graph_tensors(neigh, dist, CPU)
    D, L, rounds = cluster._bellman_ford(torch.from_numpy(D0),
                                         torch.from_numpy(L0), nt, dt,
                                         max_rounds=max_rounds)
    np.testing.assert_array_equal(D.numpy(), np.asarray(ref_D))
    np.testing.assert_array_equal(L.numpy(), np.asarray(ref_L))
    assert rounds == int(ref_rounds) and (rounds == 2) == (max_rounds == 2)

    # through cluster_labels, and against scipy's Dijkstra
    ref_labels, ref_Dc = ref_cluster.cluster_labels(V, samples, neigh)
    bf_rounds = []
    labels, Dc = cluster.cluster_labels(V, samples, neigh, engine="device",
                                        device="cpu", rounds=bf_rounds)
    np.testing.assert_array_equal(labels, np.asarray(ref_labels))
    np.testing.assert_array_equal(Dc, np.asarray(ref_Dc))
    assert bf_rounds[0] >= 2
    ii, jj = neighbors_to_edges(neigh)
    g = sp.coo_matrix((np.linalg.norm(V[ii] - V[jj], axis=1), (ii, jj)),
                      shape=(n, n)).tocsr()
    exact = dijkstra(g, indices=samples).min(axis=0)
    np.testing.assert_allclose(Dc, exact, atol=1e-4)
    assert (labels[samples] == np.arange(len(samples))).all()


@pytest.fixture(scope="module")
def sphere_level(sphere_mesh):
    """Level 0 of the sphere: samples, labels and coarse graph from the
    device engines, coarse positions both ways (barycenters, samples)."""
    V, neigh, dist, r = _graph(sphere_mesh)
    samples, _ = sampling.parallel_disk_sample(V, neigh, r, seed=3,
                                               engine="luby", device="cpu")
    labels, _ = cluster.cluster_labels(V, samples, neigh, engine="device",
                                       device="cpu")
    cn = builder._coarse_graph(labels, neigh, len(samples), "device")
    pos = {nested: builder._coarse_positions(V, labels, samples, cn, nested)
           for nested in (False, True)}
    return V, samples, labels, cn, pos


@pytest.mark.parametrize("nested", [False, True])
@pytest.mark.parametrize("check_voronoi", [True, False])
@pytest.mark.parametrize("weighting", [0, 1, 2])
def test_prolongation_weights_device_matches_reference(
        sphere_level, weighting, check_voronoi, nested):
    V, samples, labels, cn, pos = sphere_level
    n, nc = V.shape[0], len(samples)
    kw = dict(check_voronoi=check_voronoi, nested=nested, samples=samples,
              weighting=weighting)
    ref_cols, ref_w, ref_stats = ref_prolongation.prolongation_weights(
        V, labels, pos[nested], cn, **kw)
    # blocks smaller than N, so the block loop and its tail run
    cols, w, stats = prolongation.prolongation_weights(
        V, labels, pos[nested], cn, block=1000, engine="device", device="cpu",
        **kw)
    assert cols.shape == (n, 3) and cols.dtype == np.int32
    assert w.dtype == np.float32 and stats.dtype == np.int64
    _u_rows_close(_csr(cols, w, nc), _csr(ref_cols, ref_w, nc), n)
    np.testing.assert_allclose(w.sum(axis=1), 1.0, atol=1e-6)
    assert np.abs(stats - np.asarray(ref_stats)).max() <= 1e-3 * n
    assert stats.sum() <= n


def test_prolongation_weights_single_neighbor_cells():
    """Kc = 1 (no neighbor pairs, Kp = 0): every row takes the segment to
    its cell's one neighbor, or itself; no argmin over an empty axis."""
    P = np.array([[0.0, 0, 0], [0.3, 0, 0], [1.0, 0, 0], [0.9, 0.1, 0]])
    Q = np.array([[0.0, 0, 0], [1.0, 0, 0]])
    cn = np.array([[1], [0]], np.int32)
    labels = np.array([0, 0, 1, 1], np.int32)
    cols, w, stats = prolongation.prolongation_weights(
        P, labels, Q, cn, engine="device", device="cpu")
    U = _csr(cols, w, 2).toarray()
    np.testing.assert_allclose(U @ Q[:, 0], P[:, 0], atol=1e-6)
    np.testing.assert_array_equal(stats, [0, 0, 0])


HIERARCHIES = {
    "ours": (builder.build_hierarchy, ref_builder.build_hierarchy),
    "sig06": (variants.build_hierarchy_sig06, ref_variants.build_hierarchy_sig06),
    "ablation": (variants.build_hierarchy_ablation,
                 ref_variants.build_hierarchy_ablation),
}


@pytest.mark.parametrize("kind,mesh,lower_bound", [
    ("ours", "sphere_mesh", 100),
    ("ours", "torus96", 300),
    ("sig06", "sphere_mesh", 100),
    ("ablation", "sphere_mesh", 100),
])
def test_device_hierarchy_matches_reference(kind, mesh, lower_bound, request):
    m = request.getfixturevalue(mesh)
    build, ref_build = HIERARCHIES[kind]
    ref = ref_build(m["V"], m["neigh"], lower_bound=lower_bound, seed=3)
    got = build(m["V"], m["neigh"], lower_bound=lower_bound, seed=3,
                engine="device", device="cpu")
    assert got.dof == ref.dof and len(got.dof) >= 3
    for a, b in zip(got.levels, ref.levels):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.labels, b.labels)
        np.testing.assert_array_equal(a.coarse_neigh, b.coarse_neigh)
        np.testing.assert_array_equal(a.coarse_points, b.coarse_points)
        n = a.labels.shape[0]
        _u_rows_close(a.U.to_scipy(), b.U.to_scipy(), n)
        np.testing.assert_allclose(np.asarray(a.U.to_scipy().sum(axis=1)).ravel(),
                                   1.0, atol=1e-6)
        assert np.abs(a.stats - np.asarray(b.stats)).max() <= 1e-3 * n
    if kind == "ours":
        for lvl in got.levels:
            assert len(lvl.rounds["luby"]) >= 1 and lvl.rounds["bellman_ford"] >= 2


@pytest.mark.parametrize("poisson", [False, True])
def test_facade_device_engine_matches_reference(medium_mesh, poisson):
    m = medium_mesh
    S, M = m["S"], m["M"]
    lhs = (1e-6 * M + S).tocsr() if poisson else (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(42).standard_normal((S.shape[0], 1))
    ref = RefSolver(m["V"], m["neigh"], M, lower_bound=300)
    ref.solve(lhs, rhs)
    port = MultigridSolver(m["V"], m["neigh"], M, lower_bound=300,
                           device="cpu", hierarchy_engine="device")
    x = port.solve(lhs, rhs)
    assert port.hierarchy.dof == ref.hierarchy.dof
    assert port.solver_timing["iterations"] == ref.solver_timing["iterations"]
    assert np.isfinite(x).all() and port.residual(lhs, rhs, x) <= 1e-4


@pytest.mark.parametrize("kind", ["ours", "sig06", "ablation", "fps"])
def test_device_build_never_touches_native(sphere_mesh, monkeypatch, kind):
    def no_native():
        raise RuntimeError("native library unavailable")

    monkeypatch.setattr(native, "get_lib", no_native)
    V, neigh = sphere_mesh["V"], sphere_mesh["neigh"]
    if kind == "fps":
        h = builder.build_hierarchy(V, neigh, lower_bound=100,
                                    sampling_strategy=Sampling.FPS,
                                    engine="device", device="cpu")
        ref = ref_builder.build_hierarchy(V, neigh, lower_bound=100,
                                          sampling_strategy=Sampling.FPS)
        for a, b in zip(h.levels, ref.levels):
            np.testing.assert_array_equal(a.samples, b.samples)
    else:
        h = HIERARCHIES[kind][0](V, neigh, lower_bound=100, engine="device",
                                 device="cpu")
    assert len(h.dof) >= 3
    with pytest.raises(RuntimeError, match="unavailable"):
        builder.build_hierarchy(V, neigh, lower_bound=100)


def test_device_engine_needs_a_gpu_by_default(sphere_mesh):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a GPU")
    V, neigh, M = sphere_mesh["V"], sphere_mesh["neigh"], sphere_mesh["M"]
    with pytest.raises(RuntimeError, match="cuda"):
        MultigridSolver(V, neigh, M, lower_bound=100, hierarchy_engine="device")
    with pytest.raises(RuntimeError, match="cuda"):
        builder.build_hierarchy(V, neigh, lower_bound=100, engine="device")
    with pytest.raises(RuntimeError, match="cuda"):
        sampling.parallel_disk_sample(V, neigh, 0.1, engine="luby")
    with pytest.raises(ValueError, match="engine"):
        builder.build_hierarchy(V, neigh, engine="luby", device="cpu")
    # the native default takes no device, so the CPU builds it
    h = builder.build_hierarchy(V, neigh, lower_bound=100)
    assert h.levels[0].rounds is None


def test_native_loader_failure_names_the_device_engine(monkeypatch, tmp_path):
    def failing_build():
        raise RuntimeError("native build failed (g++ ...)")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_SO", tmp_path / "missing.so")
    monkeypatch.setattr(native, "_build", failing_build)
    with pytest.raises(RuntimeError, match='hierarchy_engine="device"'):
        native.get_lib()
