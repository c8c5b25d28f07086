"""Padded neighbor-array graph utilities.

The whole framework describes graphs as homogeneous ``(N, K)`` int32 arrays
padded with ``-1`` — the same contract as the reference Python package
(`gravomg_bindings/src/gravomg/util.py:4-44`) — because padded arrays
are the static-shape representation the device layouts are built from.  All functions here
are host-side (numpy) setup utilities.
"""

from __future__ import annotations

import numpy as np


def coalesce_edges(node_i: np.ndarray, node_j: np.ndarray):
    """Sort (i, j) edge lists and drop duplicate edges.

    Uses a packed int64 key (``np.unique`` with ``axis=`` falls back to a
    structured-array sort — ~20 s at 12M edges vs <1 s here).
    """
    node_i = np.asarray(node_i, dtype=np.int64)
    node_j = np.asarray(node_j, dtype=np.int64)
    if node_i.size == 0:
        return node_i, node_j
    width = max(int(node_i.max()), int(node_j.max())) + 1
    key = node_i * width + node_j
    from ..native import unique_i64

    uniq = unique_i64(key)
    return uniq // width, uniq % width


def homogenize_edges(node_i: np.ndarray, node_j: np.ndarray, num_nodes=None):
    """Convert a COO edge list into a padded (N, K) neighbor array.

    ``K`` is the max out-degree; missing entries are -1.  Mirrors the contract
    of ``homogenize_edges`` in the reference util
    (`gravomg_bindings/src/gravomg/util.py:36-44`) but tolerates isolated
    nodes (degree 0) instead of dropping them.
    """
    node_i = np.asarray(node_i, dtype=np.int64)
    node_j = np.asarray(node_j, dtype=np.int64)
    if num_nodes is None:
        num_nodes = int(node_i.max()) + 1 if node_i.size else 0
    order = np.argsort(node_i, kind="stable")
    node_i = node_i[order]
    node_j = node_j[order]
    degree = np.bincount(node_i, minlength=num_nodes)
    k = int(degree.max()) if degree.size else 0
    k = max(k, 1)
    # Position of each edge within its row.
    row_start = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(degree, out=row_start[1:])
    slot = np.arange(node_i.shape[0]) - row_start[node_i]
    neigh = np.full((num_nodes, k), -1, dtype=np.int32)
    neigh[node_i, slot] = node_j
    return neigh


def neighbors_from_stiffness(S) -> np.ndarray:
    """Neighbor array from the sparsity pattern of a stiffness matrix.

    Parity with `gravomg_bindings/src/gravomg/util.py:4-8`. Self-loops
    (diagonal entries) are removed so rows contain true neighbors only.
    """
    S_coo = S.tocoo()
    mask = S_coo.row != S_coo.col
    return homogenize_edges(
        S_coo.row[mask], S_coo.col[mask], num_nodes=S.shape[0]
    )


def neighbors_from_faces(F: np.ndarray, num_nodes=None) -> np.ndarray:
    """Neighbor array from triangle faces (undirected 1-ring).

    Parity with `gravomg_bindings/src/gravomg/util.py:10-13`.
    """
    F = np.asarray(F)
    node_i = np.concatenate([F[:, 0], F[:, 0], F[:, 1], F[:, 1], F[:, 2], F[:, 2]])
    node_j = np.concatenate([F[:, 1], F[:, 2], F[:, 0], F[:, 2], F[:, 0], F[:, 1]])
    return homogenize_edges(*coalesce_edges(node_i, node_j), num_nodes=num_nodes)


def knn(V: np.ndarray, k: int) -> np.ndarray:
    """k nearest neighbors (excluding self) via scipy KDTree."""
    from scipy.spatial import KDTree

    tree = KDTree(V)
    return tree.query(V, k + 1)[1][:, 1:]


def knn_undirected(V: np.ndarray, k: int) -> np.ndarray:
    """Symmetrized kNN neighbor array (parity: util.py:19-27)."""
    n = V.shape[0]
    node_i = np.repeat(np.arange(n), k)
    node_j = knn(V, k).reshape(-1)
    ii = np.concatenate([node_i, node_j])
    jj = np.concatenate([node_j, node_i])
    return homogenize_edges(*coalesce_edges(ii, jj), num_nodes=n)


def neighbors_to_edges(neigh: np.ndarray):
    """Inverse of homogenize_edges: padded array -> COO edge list."""
    n, k = neigh.shape
    node_i = np.repeat(np.arange(n), k)
    node_j = neigh.reshape(-1)
    mask = node_j >= 0
    return node_i[mask], node_j[mask].astype(np.int64)
