"""Frozen copies of the mesh generator and the operator assembly.

The benchmark makes its torus inputs with these (``inputs/torus.py``), and
the reference recomputes the operators with them, so a change to the
program's own versions (``gravo_mg_tpu_torch/utils/{meshgen,laplacian,
normalize}.py``) moves neither the inputs nor the yardstick.  Plain
NumPy/SciPy: nothing of the program is imported here.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def torus_mesh(nu: int, nv: int, R: float = 1.0, r: float = 0.4):
    """Closed torus: nu*nv vertices, 2*nu*nv faces, no boundary."""
    us = np.linspace(0.0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0.0, 2 * np.pi, nv, endpoint=False)
    U, W = np.meshgrid(us, vs, indexing="ij")
    x = (R + r * np.cos(W)) * np.cos(U)
    y = (R + r * np.cos(W)) * np.sin(U)
    z = r * np.sin(W)
    V = np.stack([x.reshape(-1), y.reshape(-1), z.reshape(-1)], axis=1)
    idx = np.arange(nu * nv).reshape(nu, nv)
    ip = np.roll(idx, -1, axis=0)
    jp = np.roll(idx, -1, axis=1)
    a = idx.reshape(-1)
    b = ip.reshape(-1)
    c = jp.reshape(-1)
    d = np.roll(ip, -1, axis=1).reshape(-1)
    F = np.concatenate(
        [np.stack([a, b, d], axis=1), np.stack([a, d, c], axis=1)], axis=0
    )
    return V.astype(np.float64), F.astype(np.int32)


def cotan_laplacian(V: np.ndarray, F: np.ndarray) -> sp.csr_matrix:
    """PSD cotan stiffness matrix (``-igl.cotmatrix(V, F)``)."""
    V = np.asarray(V, dtype=np.float64)
    F = np.asarray(F, dtype=np.int64)
    i0, i1, i2 = F[:, 0], F[:, 1], F[:, 2]
    e0 = V[i2] - V[i1]
    e1 = V[i0] - V[i2]
    e2 = V[i1] - V[i0]

    def cot(a, b):
        cross = np.cross(a, b)
        denom = np.maximum(np.linalg.norm(cross, axis=1), 1e-30)
        return np.einsum("ij,ij->i", a, b) / denom

    c0 = cot(-e1, e2)
    c1 = cot(-e2, e0)
    c2 = cot(-e0, e1)
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
    """Lumped (barycentric) diagonal mass: 1/3 of the incident face area."""
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


def face_area(pos: np.ndarray, F: np.ndarray) -> np.ndarray:
    v1, v2, v3 = pos[F[:, 0]], pos[F[:, 1]], pos[F[:, 2]]
    return np.linalg.norm(np.cross(v2 - v1, v3 - v1), axis=1) / 2


def normalize_area(pos: np.ndarray, F: np.ndarray) -> np.ndarray:
    """Scale to unit total surface area and center at the origin."""
    pos = pos / np.sqrt(face_area(pos, F).sum())
    return pos - np.mean(pos, axis=0, keepdims=True)


def mean_edge_length(V: np.ndarray, F: np.ndarray) -> float:
    F = np.asarray(F, dtype=np.int64)
    e = V[F[:, [1, 2, 0]]] - V[F]
    return float(np.linalg.norm(e, axis=2).mean())


def system_matrix(cfg: dict, S, M):
    """The configuration's LHS from its stiffness S and mass M."""
    if cfg["system"] == "poisson":
        return (cfg["eta"] * M + S).tocsr()
    if cfg["system"] == "smoothing":
        return (M + cfg["tau"] * S).tocsr()
    raise ValueError(f"unknown system {cfg['system']!r}")
