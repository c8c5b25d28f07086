"""Discrete Laplace operators (host-side assembly, scipy.sparse output).

Replaces the reference's external dependencies (`igl.cotmatrix`,
`igl.massmatrix`, `robust_laplacian.point_cloud_laplacian` — used in
the reference's `experiments/python/comparisons.py:40-47`) with
self-contained vectorized implementations.  Sign convention matches the
experiment harness: ``S = -igl.cotmatrix`` is positive semi-definite, so the
stiffness matrices returned here are PSD with positive diagonal.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def cotan_laplacian(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """PSD cotan stiffness matrix (equals ``-igl.cotmatrix(V, F)``)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    i0, i1, i2 = F[:, 0], F[:, 1], F[:, 2]
    e0 = V[i2] - V[i1]  # edge opposite vertex 0
    e1 = V[i0] - V[i2]
    e2 = V[i1] - V[i0]
    # cot of angle at vertex k = (e_a . e_b) / |e_a x e_b| for incident edges
    def cot(a, b):
        cross = np.cross(a, b)
        denom = np.maximum(np.linalg.norm(cross, axis=1), 1e-30)
        return np.einsum("ij,ij->i", a, b) / denom

    c0 = cot(-e1, e2)   # angle at vertex 0, opposite edge e0=(1,2)
    c1 = cot(-e2, e0)   # angle at vertex 1, opposite edge (2,0)
    c2 = cot(-e0, e1)   # angle at vertex 2, opposite edge (0,1)
    w = 0.5 * np.concatenate([c0, c1, c2])
    rows = np.concatenate([i1, i2, i0])
    cols = np.concatenate([i2, i0, i1])
    n = V.shape[0]
    W = sp.coo_matrix((w, (rows, cols)), shape=(n, n))
    W = W + W.T
    d = np.asarray(W.sum(axis=1)).ravel()
    S = sp.diags(d) - W
    return S.tocsr()


def mass_barycentric(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """Lumped (barycentric) diagonal mass matrix: 1/3 of incident face area."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    area = 0.5 * np.linalg.norm(
        np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]]), axis=1
    )
    n = V.shape[0]
    m = np.zeros(n)
    for k in range(3):
        np.add.at(m, F[:, k], area / 3.0)
    m = np.maximum(m, 1e-30)
    return sp.diags(m).tocsr()


def mass_voronoi(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """Voronoi-region lumped mass (igl MASSMATRIX_TYPE_VORONOI analog).

    Uses the mixed Voronoi rule: circumcentric areas for non-obtuse
    triangles, and area/2 at the obtuse corner (area/4 at the others)
    otherwise.
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    i0, i1, i2 = F[:, 0], F[:, 1], F[:, 2]
    # squared edge lengths opposite each corner
    l0 = np.sum((V[i2] - V[i1]) ** 2, axis=1)
    l1 = np.sum((V[i0] - V[i2]) ** 2, axis=1)
    l2 = np.sum((V[i1] - V[i0]) ** 2, axis=1)
    area = 0.5 * np.linalg.norm(
        np.cross(V[i1] - V[i0], V[i2] - V[i0]), axis=1
    )
    area = np.maximum(area, 1e-30)
    # cotangents (as in cotan_laplacian)
    c0 = (l1 + l2 - l0) / (4.0 * area)
    c1 = (l2 + l0 - l1) / (4.0 * area)
    c2 = (l0 + l1 - l2) / (4.0 * area)
    # Voronoi corner areas: (l_b * cot_b + l_c * cot_c) / 8 at corner a
    a0 = (l1 * c1 + l2 * c2) / 8.0
    a1 = (l2 * c2 + l0 * c0) / 8.0
    a2 = (l0 * c0 + l1 * c1) / 8.0
    obtuse0 = c0 < 0
    obtuse1 = c1 < 0
    obtuse2 = c2 < 0
    any_obtuse = obtuse0 | obtuse1 | obtuse2
    a0 = np.where(any_obtuse, np.where(obtuse0, area / 2, area / 4), a0)
    a1 = np.where(any_obtuse, np.where(obtuse1, area / 2, area / 4), a1)
    a2 = np.where(any_obtuse, np.where(obtuse2, area / 2, area / 4), a2)
    n = V.shape[0]
    m = np.zeros(n)
    np.add.at(m, i0, a0)
    np.add.at(m, i1, a1)
    np.add.at(m, i2, a2)
    m = np.maximum(m, 1e-30)
    return sp.diags(m).tocsr()


def mesh_laplacian_robust(V: np.ndarray, F: np.ndarray,
                          mollify_factor: float = 1e-5):
    """Non-manifold/degenerate-safe cotan Laplacian + barycentric mass.

    Self-contained replacement for ``robust_laplacian.mesh_laplacian``
    (reference `experiments/python/comparisons.py:40-47`,
    `demos/conformal_flow.py:18-30`), in the style of Sharp & Crane 2020
    "A Laplacian for Nonmanifold Triangle Meshes":

    * the mesh is treated as a polygon soup — faces contribute
      independently, so edges with any number of incident faces
      (non-manifold fins, T-junctions through shared vertex indices) just
      accumulate, no manifoldness assumption anywhere;
    * **intrinsic mollification**: one global length offset ``delta`` is
      added to every intrinsic edge length, chosen as the smallest value
      that gives every face a strict triangle inequality with relative
      slack ``mollify_factor`` — degenerate/sliver faces become valid
      intrinsic triangles without moving any vertex;
    * cotans and areas are then computed purely from the mollified
      intrinsic lengths (law of cosines + Heron), so no extrinsic
      degeneracy can produce NaN/inf or blow-up weights.

    (The full tufted-cover intrinsic-Delaunay construction additionally
    flips edges; mollification alone already guarantees a finite PSD
    operator with positive mass, which is what the solver needs.)

    Returns ``(S, M)`` — PSD stiffness and diagonal lumped mass.
    """
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    # drop combinatorially degenerate faces (repeated vertex indices)
    ok = (
        (F[:, 0] != F[:, 1]) & (F[:, 1] != F[:, 2]) & (F[:, 0] != F[:, 2])
    )
    F = F[ok]
    i0, i1, i2 = F[:, 0], F[:, 1], F[:, 2]
    l0 = np.linalg.norm(V[i2] - V[i1], axis=1)  # opposite corner 0
    l1 = np.linalg.norm(V[i0] - V[i2], axis=1)
    l2 = np.linalg.norm(V[i1] - V[i0], axis=1)
    mean_l = max(float(np.mean([l0.mean(), l1.mean(), l2.mean()])), 1e-300)
    eps = mollify_factor * mean_l
    # smallest delta s.t. every permutation satisfies l_a + l_b >= l_c + eps
    viol = np.maximum(
        np.maximum(eps + l0 - l1 - l2, eps + l1 - l2 - l0),
        eps + l2 - l0 - l1,
    )
    delta = max(float(viol.max(initial=0.0)), 0.0)
    l0, l1, l2 = l0 + delta, l1 + delta, l2 + delta
    # Heron (numerically stable ordering not critical post-mollification)
    s = 0.5 * (l0 + l1 + l2)
    area = np.sqrt(
        np.maximum(s * (s - l0) * (s - l1) * (s - l2), 1e-300)
    )
    # intrinsic cotans from the law of cosines: cot_a = (b^2+c^2-a^2)/(4A)
    c0 = (l1**2 + l2**2 - l0**2) / (4.0 * area)
    c1 = (l2**2 + l0**2 - l1**2) / (4.0 * area)
    c2 = (l0**2 + l1**2 - l2**2) / (4.0 * area)
    w = 0.5 * np.concatenate([c0, c1, c2])
    rows = np.concatenate([i1, i2, i0])
    cols = np.concatenate([i2, i0, i1])
    n = V.shape[0]
    W = sp.coo_matrix((w, (rows, cols)), shape=(n, n))
    W = W + W.T
    d = np.asarray(W.sum(axis=1)).ravel()
    S = (sp.diags(d) - W).tocsr()
    m = np.zeros(n)
    for k, idx in enumerate((i0, i1, i2)):
        np.add.at(m, idx, area / 3.0)
    # isolated vertices get a tiny mass so M stays invertible
    m = np.where(m > 0, m, max(float(area.mean()), 1e-30) * 1e-3)
    M = sp.diags(m).tocsr()
    return S, M


def point_cloud_laplacian(V: np.ndarray, k: int = 12):
    """Graph Laplacian + mass for a raw point cloud (no faces).

    Self-contained stand-in for ``robust_laplacian.point_cloud_laplacian``
    (used by `demos/conformal_flow_pointcloud.py:15-91` in the reference):
    symmetrized-kNN graph with Gaussian edge weights at the local length
    scale, diagonal mass from mean neighbor spacing.  Returns (S, M) with S
    PSD.
    """
    from .neighbors import knn_undirected, neighbors_to_edges

    V = np.asarray(V, dtype=np.float64)
    neigh = knn_undirected(V, k)
    ii, jj = neighbors_to_edges(neigh)
    d2 = np.sum((V[ii] - V[jj]) ** 2, axis=1)
    # Local bandwidth: mean squared neighbor distance.
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
    # Mass: local area estimate ~ (mean spacing)^2
    m = np.maximum(sigma2, 1e-30)
    M = sp.diags(m / m.mean()).tocsr()
    return S.tocsr(), M


def per_vertex_normals(V: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Area-weighted per-vertex normals."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    fn = np.cross(V[F[:, 1]] - V[F[:, 0]], V[F[:, 2]] - V[F[:, 0]])
    n = np.zeros_like(V)
    for kk in range(3):
        np.add.at(n, F[:, kk], fn)
    norm = np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    return n / norm
