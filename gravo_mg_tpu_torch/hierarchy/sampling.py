"""Coarse-point sampling on the host.

Counterpart of ``gravo_mg_tpu/hierarchy/sampling.py`` on its native path:
the greedy disk sweep (``fastDiskSample`` / MIS contract of the reference,
`gravomg/src/multigrid_solver.cpp:930-1013`) runs in C++
(native/gravomg_native.cpp ``disk_sample``); RANDOM and POISSONDISK are
numpy; FPS is the native incremental Dijkstra.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

UNDECIDED, SAMPLE, DOMINATED = 0, 1, 2
_IMAX = np.iinfo(np.int32).max


def edge_lengths_np(pos: np.ndarray, neigh: np.ndarray) -> np.ndarray:
    """(N, K) float32 edge lengths, inf at padding."""
    safe = np.maximum(neigh, 0)
    d = np.linalg.norm(
        pos[safe] - pos[:, None, :], axis=-1
    ).astype(np.float32)
    d[neigh < 0] = np.inf
    return d


def parallel_disk_sample(
    pos: np.ndarray,
    neigh: np.ndarray,
    radius: float,
    *,
    two_ring: bool = True,
    dist: Optional[np.ndarray] = None,
    order: Optional[np.ndarray] = None,
):
    """Sample coarse points: fastDiskSample / MIS contract.

    Returns ``(samples, status)``: sample vertex indices in ascending order
    and the per-vertex status array.  ``dist`` shares one precomputed
    edge-length table across phases; ``order`` sets the greedy visit order
    (default: index order, like the reference's sweep).
    """
    from ..native import disk_sample_native

    if dist is None:
        dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
    status = np.zeros(neigh.shape[0], dtype=np.int8)
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
                          dist: Optional[np.ndarray] = None) -> np.ndarray:
    """Graph farthest-point sampling (reference `constructFarthestPointSample`,
    gravomg/src/sampling.cpp:6-66), by incremental Dijkstra in C++."""
    from ..native import fps_graph_native

    if dist is None:
        dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
    return np.sort(fps_graph_native(neigh, dist, int(target))).astype(np.int32)
