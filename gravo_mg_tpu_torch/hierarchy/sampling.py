"""Coarse-point sampling: native greedy sweep or Luby rounds on a device.

Counterpart of ``gravo_mg_tpu/hierarchy/sampling.py``.  Both engines keep
the contract of the reference's sweeps (``fastDiskSample`` / MIS,
`gravomg/src/multigrid_solver.cpp:930-1013`): a maximal set of samples
pairwise at least ``radius`` apart, covering all vertices.

* **native** (default): the greedy disk sweep in C++
  (native/gravomg_native.cpp ``disk_sample``), in index order or the
  caller's ``order``; it takes no seed.
* **luby**: every vertex draws a seeded random priority; each round all
  undecided vertices that hold the minimum priority within their conflict
  ball join the sample set at once, and their balls are dominated.  The
  rounds run in torch on ``device``, O(log N) of them.

RANDOM and POISSONDISK are numpy; FPS is the native incremental Dijkstra,
or scipy's repeated Dijkstra under the device engine.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..sparse import resolve_device

UNDECIDED, SAMPLE, DOMINATED = 0, 1, 2
_IMAX = np.iinfo(np.int32).max
# Rounds between host reads of a device loop's stop condition; a round
# past the fixed point changes nothing, so the result does not depend on it.
CHECK_EVERY = 4


def edge_lengths_np(pos: np.ndarray, neigh: np.ndarray) -> np.ndarray:
    """(N, K) float32 edge lengths, inf at padding."""
    safe = np.maximum(neigh, 0)
    d = np.linalg.norm(
        pos[safe] - pos[:, None, :], axis=-1
    ).astype(np.float32)
    d[neigh < 0] = np.inf
    return d


def graph_tensors(neigh, dist, device):
    """(int64 neighbor, float32 edge-length) tensors on ``device``; tensors
    already there pass through without a copy."""
    return (torch.as_tensor(neigh, device=device).long(),
            torch.as_tensor(dist, dtype=torch.float32, device=device))


def _conflict_min(q, neigh, dist, radius, two_ring, block):
    """s[i] = min of q over the conflict ball of i (excluding i itself).

    q is an int32 priority vector with _IMAX marking inert vertices.  The
    conflict ball is {j : d(i,j) < r} plus, when ``two_ring``,
    {m : d(i,j) + d(j,m) < r for some neighbor j}.  Rows are independent;
    ``block`` rows at a time bound the (B, K, K) temporaries.
    """
    n = neigh.shape[0]
    out = torch.empty_like(q)
    for start in range(0, n, block):
        end = min(start + block, n)
        nb, db = neigh[start:end], dist[start:end]          # (B, K)
        safe_nb = nb.clamp_min(0)
        ok1 = (nb >= 0) & (db < radius)
        m1 = torch.where(ok1, q[safe_nb], _IMAX).amin(1)
        if two_ring:
            nb2, db2 = neigh[safe_nb], dist[safe_nb]        # (B, K, K)
            rows = torch.arange(start, end, device=nb.device)
            ok2 = (ok1[:, :, None] & (nb2 >= 0)
                   & (db[:, :, None] + db2 < radius)
                   & (nb2 != rows[:, None, None]))
            m2 = torch.where(ok2, q[nb2.clamp_min(0)], _IMAX).amin((1, 2))
            m1 = torch.minimum(m1, m2)
        out[start:end] = m1
    return out


def _luby_round(status, rank, neigh, dist, radius, *, two_ring, block):
    """One Luby round: select local-min-priority vertices, dominate their
    balls.  Returns the new int8 status and the undecided count (a device
    scalar: reading it waits for the device)."""
    undecided = status == UNDECIDED
    s = _conflict_min(torch.where(undecided, rank, _IMAX), neigh, dist,
                      radius, two_ring, block)
    new_sample = undecided & (rank < s)
    # An undecided vertex is dominated if a new sample lies in its ball.
    ns_rank = (~new_sample).to(torch.int32) * _IMAX
    t = _conflict_min(ns_rank, neigh, dist, radius, two_ring, block)
    dominated = undecided & ~new_sample & (t == 0)
    status = torch.where(new_sample, SAMPLE,
                         torch.where(dominated, DOMINATED, status))
    return status, (status == UNDECIDED).sum()


def _luby_sample(neigh, dist, radius, two_ring, seed, block, max_rounds,
                 device):
    """Luby rounds until no vertex is undecided (or ``max_rounds``).

    Returns the host int8 status and the rounds the reference's loop runs
    (it reads the count after every round; here it is read every
    CHECK_EVERY rounds and the rounds that left vertices undecided are
    counted on the device)."""
    neigh, dist = graph_tensors(neigh, dist, device)
    n = neigh.shape[0]
    # The reference draws the priorities on the host with numpy.
    rank = torch.from_numpy(
        np.random.default_rng(seed).permutation(n).astype(np.int32)
    ).to(device)
    status = torch.zeros(n, dtype=torch.int8, device=device)
    busy = torch.zeros((), dtype=torch.int64, device=device)
    radius = float(np.float32(radius))
    for r in range(max_rounds):
        status, undecided = _luby_round(status, rank, neigh, dist, radius,
                                        two_ring=two_ring, block=block)
        busy += undecided > 0
        if (r + 1) % CHECK_EVERY == 0 and int(undecided) == 0:
            break
    return status.cpu().numpy(), min(int(busy) + 1, max_rounds)


def parallel_disk_sample(
    pos: np.ndarray,
    neigh,
    radius: float,
    *,
    two_ring: bool = True,
    seed: int = 0,
    block: int = 65536,
    max_rounds: int = 200,
    dist=None,
    engine: str = "native",
    order: Optional[np.ndarray] = None,
    device="cuda",
    rounds: Optional[list] = None,
):
    """Sample coarse points: fastDiskSample / MIS contract.

    Returns ``(samples, status)``: sample vertex indices in ascending order
    and the per-vertex int8 status array.  ``dist`` shares one precomputed
    edge-length table across phases.  ``engine="native"`` runs the greedy
    sweep in ``order`` (default: index order, like the reference's sweep);
    ``engine="luby"`` runs Luby rounds on ``device`` from the priorities
    ``default_rng(seed).permutation(N)``, ``block`` rows at a time, for at
    most ``max_rounds`` rounds, and appends the rounds it ran to
    ``rounds`` when that is a list.  Under ``"luby"``, ``neigh`` and
    ``dist`` may already be tensors on ``device`` (``graph_tensors``).
    """
    if engine not in ("native", "luby"):
        raise ValueError(f"engine must be 'native' or 'luby', got {engine!r}")
    if dist is None:
        dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
    n = neigh.shape[0]
    if engine == "luby":
        status, ran = _luby_sample(
            neigh, dist, radius, two_ring, seed, min(block, max(256, n)),
            max_rounds, resolve_device(device),
        )
        if rounds is not None:
            rounds.append(ran)
    else:
        from ..native import disk_sample_native

        status = np.zeros(n, dtype=np.int8)
        disk_sample_native(neigh, dist, radius, two_ring, status, order=order)
    samples = np.nonzero(status == SAMPLE)[0].astype(np.int32)
    return samples, status


def random_sample(n: int, target: int, seed: int = 0) -> np.ndarray:
    """Uniform random subset (reference RANDOM case,
    multigrid_solver.cpp:143-149)."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.permutation(n)[:target]).astype(np.int32)


def poisson_disk_sample(pos: np.ndarray, radius: float, seed: int = 0) -> np.ndarray:
    """Euclidean Poisson-disk sampling via Luby rounds on the radius graph.

    Parallel replacement for the reference's box dart-throwing sampler
    (`constructPoissonDiskSample`, multigrid_solver.cpp:714-928): same
    contract (maximal set with pairwise Euclidean distance >= radius),
    order-free.  Conflict pairs come from a KD-tree radius query.
    """
    from scipy.spatial import KDTree

    n = pos.shape[0]
    tree = KDTree(pos)
    pairs = tree.query_pairs(radius, output_type="ndarray")
    rng = np.random.default_rng(seed)
    rank = rng.permutation(n)
    status = np.zeros(n, dtype=np.int8)
    ii = np.concatenate([pairs[:, 0], pairs[:, 1]])
    jj = np.concatenate([pairs[:, 1], pairs[:, 0]])
    for _ in range(200):
        q = np.where(status == UNDECIDED, rank, _IMAX)
        s = np.full(n, _IMAX, dtype=np.int64)
        np.minimum.at(s, ii, q[jj])
        new_sample = (status == UNDECIDED) & (rank < s)
        dom = np.zeros(n, dtype=bool)
        dom[ii[new_sample[jj]]] = True
        status[new_sample] = SAMPLE
        status[(status == UNDECIDED) & ~new_sample & dom] = DOMINATED
        if not (status == UNDECIDED).any():
            break
    return np.nonzero(status == SAMPLE)[0].astype(np.int32)


def farthest_point_sample(pos: np.ndarray, neigh: np.ndarray, target: int,
                          dist: Optional[np.ndarray] = None,
                          engine: str = "native") -> np.ndarray:
    """Graph farthest-point sampling (reference `constructFarthestPointSample`,
    gravomg/src/sampling.cpp:6-66): repeatedly add the vertex farthest (in
    graph distance) from the current sample set.

    ``engine="native"``: incremental Dijkstra in C++.  ``engine="device"``:
    scipy's repeated full Dijkstra (the JAX package's route without its
    native library), same semantics, for small inputs.
    """
    if engine == "native":
        from ..native import fps_graph_native

        if dist is None:
            dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
        return np.sort(fps_graph_native(neigh, dist, int(target))).astype(np.int32)
    if engine != "device":
        raise ValueError(f"engine must be 'native' or 'device', got {engine!r}")

    import scipy.sparse as sp
    from scipy.sparse.csgraph import dijkstra

    from ..utils.neighbors import neighbors_to_edges

    n = pos.shape[0]
    ii, jj = neighbors_to_edges(neigh)
    w = np.linalg.norm(pos[ii] - pos[jj], axis=1)
    g = sp.coo_matrix((w, (ii, jj)), shape=(n, n)).tocsr()
    samples = [0]
    D = dijkstra(g, indices=0)
    for _ in range(target - 1):
        nxt = int(np.argmax(np.where(np.isfinite(D), D, -1)))
        samples.append(nxt)
        D = np.minimum(D, dijkstra(g, indices=nxt))
    return np.sort(np.asarray(samples, dtype=np.int32))
