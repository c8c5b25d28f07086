"""A point cloud with no faces: ``mesh = {"kind": "point_cloud", "n",
"seed", "surface", "k", "order"}``.

The points are sampled from ``surface`` (``"sphere"`` or ``"torus"``) with
the mesh entry's own ``seed``, centred and scaled into the unit box, then
either kept in the generator's order (``order`` ``"sampled"``) or sorted
along the Morton curve (``"morton"``, the spatially coherent order of a scan
read from a file).  ``S`` and ``M`` are the kNN graph Laplacian and its mass
over ``k`` neighbours (default 12); ``h`` is the mean distance between the
points of S's off-diagonal entries.

Frozen copies of the program's ``utils/meshgen.py::point_cloud``,
``utils/normalize.py::normalize_bounding_box``, ``utils/neighbors.py``'s
kNN graph and ``utils/laplacian.py::point_cloud_laplacian`` and
``utils/morton.py::morton_order``: plain NumPy/SciPy (``np.unique`` where
the program sorts unique keys natively), so a change to the program's
versions moves neither the inputs nor the yardstick.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import Inputs


def point_cloud(n: int, seed: int = 0, surface: str = "sphere"):
    """Deterministic point cloud sampled from a curved surface."""
    rng = np.random.default_rng(seed)
    if surface == "sphere":
        v = rng.standard_normal((n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        r = 1.0 + 0.1 * np.sin(4 * v[:, 0]) * np.sin(3 * v[:, 1])
        return (v * r[:, None]).astype(np.float64)
    if surface == "torus":
        u = rng.random(n) * 2 * np.pi
        w = rng.random(n) * 2 * np.pi
        R, r = 1.0, 0.4
        return np.stack(
            [
                (R + r * np.cos(w)) * np.cos(u),
                (R + r * np.cos(w)) * np.sin(u),
                r * np.sin(w),
            ],
            axis=1,
        )
    raise ValueError(f"unknown surface {surface!r}")


def normalize_bounding_box(pos: np.ndarray) -> np.ndarray:
    """Center and scale so the bounding box fits in [-0.5, 0.5]^3."""
    pos = pos - pos.mean(axis=0, keepdims=True)
    return pos * (0.5 / np.abs(pos).max())


def _part1by2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_order(pos: np.ndarray) -> np.ndarray:
    """Permutation sorting the points along the Z-curve (21 bits an axis),
    stable."""
    p = np.asarray(pos, dtype=np.float64)
    lo = p.min(axis=0)
    span = p.max(axis=0) - lo
    span[span <= 0] = 1.0
    q = ((p - lo) / span * ((1 << 21) - 1)).astype(np.uint64)
    key = (_part1by2(q[:, 0])
           | (_part1by2(q[:, 1]) << np.uint64(1))
           | (_part1by2(q[:, 2]) << np.uint64(2)))
    return np.argsort(key, kind="stable")


def coalesce_edges(node_i: np.ndarray, node_j: np.ndarray):
    """Sort (i, j) edge lists and drop duplicate edges."""
    node_i = np.asarray(node_i, dtype=np.int64)
    node_j = np.asarray(node_j, dtype=np.int64)
    if node_i.size == 0:
        return node_i, node_j
    width = max(int(node_i.max()), int(node_j.max())) + 1
    uniq = np.unique(node_i * width + node_j)
    return uniq // width, uniq % width


def homogenize_edges(node_i: np.ndarray, node_j: np.ndarray, num_nodes=None):
    """A COO edge list as a padded (N, K) neighbour array, -1 padded."""
    node_i = np.asarray(node_i, dtype=np.int64)
    node_j = np.asarray(node_j, dtype=np.int64)
    if num_nodes is None:
        num_nodes = int(node_i.max()) + 1 if node_i.size else 0
    order = np.argsort(node_i, kind="stable")
    node_i = node_i[order]
    node_j = node_j[order]
    degree = np.bincount(node_i, minlength=num_nodes)
    k = max(int(degree.max()) if degree.size else 0, 1)
    row_start = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(degree, out=row_start[1:])
    slot = np.arange(node_i.shape[0]) - row_start[node_i]
    neigh = np.full((num_nodes, k), -1, dtype=np.int32)
    neigh[node_i, slot] = node_j
    return neigh


def knn(V: np.ndarray, k: int) -> np.ndarray:
    """k nearest neighbours (excluding self) via SciPy's KDTree."""
    from scipy.spatial import KDTree

    return KDTree(V).query(V, k + 1)[1][:, 1:]


def knn_undirected(V: np.ndarray, k: int) -> np.ndarray:
    """Symmetrized kNN neighbour array."""
    n = V.shape[0]
    node_i = np.repeat(np.arange(n), k)
    node_j = knn(V, k).reshape(-1)
    ii = np.concatenate([node_i, node_j])
    jj = np.concatenate([node_j, node_i])
    return homogenize_edges(*coalesce_edges(ii, jj), num_nodes=n)


def neighbors_to_edges(neigh: np.ndarray):
    """Padded neighbour array -> COO edge list."""
    n, k = neigh.shape
    node_i = np.repeat(np.arange(n), k)
    node_j = neigh.reshape(-1)
    mask = node_j >= 0
    return node_i[mask], node_j[mask].astype(np.int64)


def point_cloud_laplacian(V: np.ndarray, k: int = 12):
    """``(S, M)``: the symmetrized-kNN graph Laplacian with Gaussian edge
    weights at the local length scale (PSD), and the diagonal mass from the
    mean squared neighbour spacing, scaled to mean 1."""
    V = np.asarray(V, dtype=np.float64)
    ii, jj = neighbors_to_edges(knn_undirected(V, k))
    d2 = np.sum((V[ii] - V[jj]) ** 2, axis=1)
    n = V.shape[0]
    sums = np.bincount(ii, weights=d2, minlength=n)
    cnts = np.maximum(np.bincount(ii, minlength=n), 1)
    sigma2 = sums / cnts
    band = 0.5 * (sigma2[ii] + sigma2[jj]) + 1e-30
    w = np.exp(-d2 / band)
    W = sp.coo_matrix((w, (ii, jj)), shape=(n, n)).tocsr()
    W = 0.5 * (W + W.T)
    d = np.asarray(W.sum(axis=1)).ravel()
    S = sp.diags(d) - W
    m = np.maximum(sigma2, 1e-30)
    M = sp.diags(m / m.mean()).tocsr()
    return S.tocsr(), M


def mean_offdiagonal_length(V: np.ndarray, S) -> float:
    """Mean distance between the two points of each off-diagonal entry."""
    C = S.tocoo()
    off = C.row != C.col
    return float(np.linalg.norm(V[C.row[off]] - V[C.col[off]], axis=1).mean())


ORDERS = ("sampled", "morton")


def make(mesh: dict) -> Inputs:
    order = mesh.get("order", "sampled")
    if order not in ORDERS:
        raise ValueError(f"unknown point order {order!r}; one of {ORDERS}")
    V = normalize_bounding_box(point_cloud(int(mesh["n"]), seed=mesh["seed"],
                                           surface=mesh["surface"]))
    if order == "morton":
        V = np.ascontiguousarray(V[morton_order(V)])
    k = int(mesh.get("k", 12))
    return Inputs(V, None, lambda: point_cloud_laplacian(V, k),
                  lambda inputs: mean_offdiagonal_length(inputs.V, inputs.S))
