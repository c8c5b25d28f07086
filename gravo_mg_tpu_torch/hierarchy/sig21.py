"""SIG21 decimation hierarchy with intrinsic prolongation.

Counterpart of ``gravo_mg_tpu/hierarchy/sig21.py``.  The reference vendors
Liu et al. 2021 "Surface Multigrid via Intrinsic Prolongation"
(`gravomg/src/sig21/`): repeated edge-collapse decimation, a joint local
parameterization (LSCM) of each collapse's pre/post 1-ring, and a
fine->coarse barycentric replay through the collapse log, producing
prolongations fed through the same cycle machinery
(`constructSIG21Hierarchy`, multigrid_solver.cpp:1488-1503; defaults ratio
0.25, min 500 vertices, midpoint decimation, mg_precompute.cpp:15-87).

:func:`build_sig21_hierarchy` runs the native decimator
(``gravo_mg_tpu/native/ssp_native.cpp``, built into the port's library):
heap-based qslim / midpoint / vertex-removal collapses under a link
condition, a per-collapse joint LSCM flatten and the barycentric replay
inline at collapse time.  The pure-Python shortest-edge decimator with
extrinsic closest-point projection (:func:`_decimate`,
:func:`_barycentric_assignment`) is kept as functions; the builder never
falls back to it.
"""

from __future__ import annotations

import heapq
import time
from typing import List

import numpy as np

from ..sparse import make_prolongation
from ..utils.neighbors import neighbors_from_faces
from .builder import Hierarchy, HierarchyLevel

_DEC_TYPES = {"qslim": 0, "midpoint": 1, "vertexremoval": 2}


def _face_quadric(p0, p1, p2):
    """Area-weighted plane quadric K = [n; d][n; d]^T of a triangle."""
    n = np.cross(p1 - p0, p2 - p0)
    area2 = np.linalg.norm(n)
    if area2 < 1e-30:
        return np.zeros((4, 4))
    n = n / area2
    d = -np.dot(n, p0)
    v = np.array([n[0], n[1], n[2], d])
    return (0.5 * area2) * np.outer(v, v)


def _quadric_cost_pos(Q, pu, pv):
    """QSLIM edge cost and optimal placement for combined quadric Q.

    Solves the 3x3 stationarity system; falls back to the best of the
    endpoints/midpoint when the quadric is (near-)singular, the policy of
    igl's qslim optimal-placement helper used by SSP_qslim.
    """
    A = Q[:3, :3]
    b = -Q[:3, 3]
    try:
        p = np.linalg.solve(A + 1e-12 * np.trace(A) * np.eye(3), b)
        if np.isfinite(p).all():
            h = np.array([p[0], p[1], p[2], 1.0])
            return float(h @ Q @ h), p
    except np.linalg.LinAlgError:
        pass
    best = (np.inf, pu)
    for p in (pu, pv, 0.5 * (pu + pv)):
        h = np.array([p[0], p[1], p[2], 1.0])
        c = float(h @ Q @ h)
        if c < best[0]:
            best = (c, p)
    return best


def _decimate(V: np.ndarray, F: np.ndarray, target_nv: int,
              strategy: str = "midpoint"):
    """Greedy edge collapse until <= target_nv vertices.

    ``strategy`` mirrors the reference's ``dec_type`` dispatch
    (SSP_decimate.cpp:25-38): ``midpoint`` collapses the shortest edge to
    its midpoint, ``qslim`` uses quadric error with optimal placement,
    ``vertexremoval`` half-collapses v into u, which stays in place.

    Returns (V_coarse, F_coarse, fine_to_coarse index map, kept indices).
    """
    V = V.copy()
    nv = V.shape[0]
    alive_v = np.ones(nv, dtype=bool)
    faces = {i: tuple(f) for i, f in enumerate(F.tolist())}
    v_faces = {i: set() for i in range(nv)}
    for fi, f in faces.items():
        for v in f:
            v_faces[v].add(fi)

    def neighbors(u):
        out = set()
        for fi in v_faces[u]:
            out.update(faces[fi])
        out.discard(u)
        return out

    quadrics = None
    if strategy == "qslim":
        quadrics = np.zeros((nv, 4, 4))
        for a, b, c in faces.values():
            K = _face_quadric(V[a], V[b], V[c])
            quadrics[a] += K
            quadrics[b] += K
            quadrics[c] += K

    def cost_pos(u, v):
        if strategy == "qslim":
            return _quadric_cost_pos(quadrics[u] + quadrics[v], V[u], V[v])
        d2 = float(np.sum((V[u] - V[v]) ** 2))
        if strategy == "vertexremoval":
            return d2, V[u].copy()
        return d2, 0.5 * (V[u] + V[v])

    heap = []
    seen_edges = set()
    for f in faces.values():
        for a, b in ((f[0], f[1]), (f[1], f[2]), (f[2], f[0])):
            e = (min(a, b), max(a, b))
            if e not in seen_edges:
                seen_edges.add(e)
                heapq.heappush(heap, (cost_pos(*e)[0], e[0], e[1]))

    n_alive = nv
    while n_alive > target_nv and heap:
        d2, u, v = heapq.heappop(heap)
        if not (alive_v[u] and alive_v[v]):
            continue
        if v not in neighbors(u):
            continue
        cur, new_pos = cost_pos(u, v)
        if cur > d2 * 1.0001 + 1e-30:  # stale entry
            heapq.heappush(heap, (cur, u, v))
            continue
        # Link condition: common neighbors must be exactly the third
        # vertices of the shared faces (manifoldness guard).
        shared_faces = v_faces[u] & v_faces[v]
        if not (1 <= len(shared_faces) <= 2):
            continue
        thirds = set()
        for fi in shared_faces:
            thirds.update(faces[fi])
        thirds -= {u, v}
        if neighbors(u) & neighbors(v) != thirds:
            continue
        # Collapse v into u at the strategy's placement.
        V[u] = new_pos
        if quadrics is not None:
            quadrics[u] = quadrics[u] + quadrics[v]
        alive_v[v] = False
        n_alive -= 1
        for fi in list(shared_faces):
            for w in faces[fi]:
                v_faces[w].discard(fi)
            del faces[fi]
        for fi in list(v_faces[v]):
            f = faces[fi]
            faces[fi] = tuple(u if x == v else x for x in f)
            v_faces[u].add(fi)
        v_faces[v] = set()
        for w in neighbors(u):
            e = (min(u, w), max(u, w))
            heapq.heappush(heap, (cost_pos(*e)[0], e[0], e[1]))

    keep = np.nonzero(alive_v)[0]
    remap = -np.ones(nv, dtype=np.int64)
    remap[keep] = np.arange(len(keep))
    Vc = V[keep]
    Fc = np.asarray(
        [
            [remap[a], remap[b], remap[c]]
            for (a, b, c) in faces.values()
            if len({a, b, c}) == 3
        ],
        dtype=np.int64,
    )
    return Vc, Fc, remap, keep


def _barycentric_assignment(Vf: np.ndarray, Vc: np.ndarray, Fc: np.ndarray,
                            kept_map: np.ndarray):
    """Map each fine vertex to (coarse tri corners, barycentric weights).

    Surviving vertices map to themselves with weight 1; collapsed vertices
    project onto candidate coarse triangles incident to their nearest
    coarse vertices.
    """
    from scipy.spatial import KDTree

    nf = Vf.shape[0]
    cols = np.zeros((nf, 3), dtype=np.int64)
    wts = np.zeros((nf, 3), dtype=np.float64)
    surviving = kept_map >= 0
    cols[surviving, 0] = kept_map[surviving]
    wts[surviving, 0] = 1.0
    lost = np.nonzero(~surviving)[0]
    if lost.size == 0 or Fc.shape[0] == 0:
        return cols, wts

    v_tris = [[] for _ in range(Vc.shape[0])]
    for ti, (a, b, c) in enumerate(Fc):
        v_tris[a].append(ti)
        v_tris[b].append(ti)
        v_tris[c].append(ti)
    tree = KDTree(Vc)
    _, nearest = tree.query(Vf[lost], k=min(4, Vc.shape[0]))
    nearest = np.atleast_2d(nearest)
    for row, i in enumerate(lost):
        p = Vf[i]
        best = (np.inf, None, None)
        cand = set()
        for cv in nearest[row]:
            cand.update(v_tris[int(cv)])
        for ti in cand:
            a, b, c = Fc[ti]
            q0, q1, q2 = Vc[a], Vc[b], Vc[c]
            e1, e2 = q1 - q0, q2 - q0
            nrm = np.cross(e1, e2)
            nn = np.dot(nrm, nrm)
            if nn < 1e-30:
                continue
            rel = p - q0
            d = np.dot(rel, nrm) / np.sqrt(nn)
            pp = p - d * (nrm / np.sqrt(nn))
            dA = np.sqrt(nn)
            b0 = np.dot(np.cross(q2 - q1, pp - q1), nrm / np.sqrt(nn)) / dA
            b1 = np.dot(np.cross(q0 - q2, pp - q2), nrm / np.sqrt(nn)) / dA
            b2 = 1.0 - b0 - b1
            bar = np.clip([b0, b1, b2], 0.0, None)
            s = bar.sum()
            bar = bar / s if s > 0 else np.array([1.0, 0, 0])
            # distance to the clipped point approximates projection dist
            proj = bar[0] * q0 + bar[1] * q1 + bar[2] * q2
            dist = float(np.sum((p - proj) ** 2))
            if dist < best[0]:
                best = (dist, (a, b, c), bar)
        if best[1] is None:
            cols[i, 0] = int(nearest[row][0])
            wts[i, 0] = 1.0
        else:
            cols[i] = best[1]
            wts[i] = best[2]
    return cols, wts


def build_sig21_hierarchy(
    pos: np.ndarray,
    faces: np.ndarray,
    *,
    coarsening_ratio: float = 0.25,
    min_coarsest: int = 500,
    max_levels: int = 10,
    dec_type: int | str = 1,
    verbose: bool = False,
) -> Hierarchy:
    """Decimation hierarchy with the reference's SIG21 defaults
    (multigrid_solver.cpp:1494-1496; midpoint decimation).

    ``dec_type`` follows SSP_decimate.h:22: 0/'qslim', 1/'midpoint'
    (default), 2/'vertexremoval'.  The hierarchy has no fine neighbor
    array (``neigh`` is (0, 1)), like the reference's.
    """
    from ..native import ssp_decimate_native

    if isinstance(dec_type, str):
        dec_int = _DEC_TYPES[dec_type]
    else:
        dec_int = int(dec_type)
        if dec_int not in _DEC_TYPES.values():
            raise ValueError(f"unknown dec_type {dec_type}")
    V = np.asarray(pos, dtype=np.float64)
    F = np.asarray(faces, dtype=np.int64)
    timing = {"sig21_hierarchy": 0.0}
    t_total = time.perf_counter()

    dof = [V.shape[0]]
    levels: List[HierarchyLevel] = []
    k = 0
    while dof[k] > min_coarsest and k < max_levels:
        target = max(int(dof[k] * coarsening_ratio), min_coarsest)
        Vc, Fc, cols, wts, alive = ssp_decimate_native(V, F, target, dec_int)
        if Vc.shape[0] >= dof[k] or Fc.shape[0] == 0:
            break
        nc = Vc.shape[0]
        if verbose:
            print(f"sig21 level {k}: {dof[k]} -> {nc}")
        coarse_neigh = neighbors_from_faces(Fc, num_nodes=nc)
        levels.append(
            HierarchyLevel(
                U=make_prolongation(cols, wts, nc),
                samples=np.flatnonzero(alive).astype(np.int32),
                labels=np.argmax(wts, axis=1).astype(np.int32),
                coarse_points=Vc,
                coarse_neigh=coarse_neigh,
                stats=np.zeros(3, dtype=np.int64),
            )
        )
        dof.append(nc)
        V, F = Vc, Fc
        k += 1

    timing["sig21_hierarchy"] = (time.perf_counter() - t_total) * 1000.0
    timing["levels"] = float(len(levels))
    timing["n_vertices"] = float(dof[0])
    return Hierarchy(dof, levels, np.asarray(pos), np.zeros((0, 1), np.int32),
                     timing)


def block_prolongations(hierarchy: Hierarchy, dim: int = 3):
    """Vector-valued (block) prolongations ``P_block = P (x) I_dim``
    (the reference's ``mg_precompute_block``, sig21/mg_precompute_block.cpp),
    for systems whose DOFs are stacked per-vertex vectors (x0,y0,z0,x1,...);
    inject them with ``MultigridSolver.set_prolongation_matrices``."""
    import scipy.sparse as sp

    eye = sp.identity(dim, format="csr")
    return [sp.kron(lvl.U.to_scipy(), eye, format="csr")
            for lvl in hierarchy.levels]
