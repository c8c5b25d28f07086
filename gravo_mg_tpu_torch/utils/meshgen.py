"""Procedural test meshes.

The reference benchmarks on a downloaded mesh dataset (its `README.md:50-58`);
this module provides deterministic procedural surfaces
(grid patch, torus, icosphere, bumpy sphere) at arbitrary resolution so the
framework's tests and benchmarks are self-contained.
"""

from __future__ import annotations

import numpy as np


def grid_mesh(nx: int, ny: int, jitter: float = 0.0, seed: int = 0):
    """Planar triangulated grid patch with optional height-field warp."""
    xs = np.linspace(0.0, 1.0, nx)
    ys = np.linspace(0.0, 1.0, ny)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    Z = 0.15 * np.sin(2 * np.pi * X) * np.cos(2 * np.pi * Y)
    V = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)
    if jitter > 0:
        rng = np.random.default_rng(seed)
        V[:, :2] += jitter * (rng.random((V.shape[0], 2)) - 0.5) / max(nx, ny)
    idx = np.arange(nx * ny).reshape(nx, ny)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[1:, :-1].reshape(-1)
    c = idx[:-1, 1:].reshape(-1)
    d = idx[1:, 1:].reshape(-1)
    F = np.concatenate(
        [np.stack([a, b, d], axis=1), np.stack([a, d, c], axis=1)], axis=0
    )
    return V.astype(np.float64), F.astype(np.int32)


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


def icosphere(subdiv: int = 3, radius: float = 1.0, bump: float = 0.0):
    """Subdivided icosahedron; `bump` adds a deterministic radial warp."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    V = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    F = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    for _ in range(subdiv):
        edge_mid = {}
        verts = [v for v in V]

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = verts[a] + verts[b]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts)
                verts.append(m)
            return edge_mid[key]

        newF = []
        for (a, b, c) in F:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            newF += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        V = np.array(verts)
        F = np.array(newF, dtype=np.int64)
    if bump > 0:
        r = 1.0 + bump * np.sin(5 * V[:, 0]) * np.sin(4 * V[:, 1]) * np.sin(3 * V[:, 2])
        V = V * r[:, None]
    return (V * radius).astype(np.float64), F.astype(np.int32)


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
