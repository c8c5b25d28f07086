"""Alternative hierarchies: the SIG06 baseline and the paper's ablation.

Counterpart of ``gravo_mg_tpu/hierarchy/variants.py``; both run through the
same cycle machinery as the main method:

* SIG06 (`constructProlongationSIG06`, multigrid_solver.cpp:528-693):
  1-ring MIS sampling, nested coarse points (= sample positions), coarse
  graph via the samples' 2-ring, prolongation by inverse-distance weights
  over each fine vertex's sampled 1-ring neighbors.
* Ablation (`constructProlongationAblation`, multigrid_solver.cpp:1520-1729):
  the main pipeline but with triangle selection replaced by
  inverse-distance weights over the n closest (or random) coarse neighbors.

As in the JAX package, SIG06 rows without a sampled 1-ring neighbor (empty
or -1 columns in the reference, multigrid_solver.cpp:637) fall back to
their nearest sample with weight 1.  Both take the main builder's
``engine``: the native index-order sweeps (which take no seed) and native
clustering, or Luby rounds seeded with ``seed + k`` at level k and
Bellman-Ford clustering on ``device``.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np

from ..sparse import make_prolongation
from ..utils.neighbors import homogenize_edges
from .builder import (
    Hierarchy,
    HierarchyLevel,
    _avg_edge_length,
    _coarse_graph,
    _coarse_positions,
    engine_device,
)
from .cluster import cluster_labels
from .sampling import parallel_disk_sample


def _edge_dists(pos, neigh):
    safe = np.maximum(neigh, 0)
    d = np.linalg.norm(pos[safe] - pos[:, None, :], axis=-1)
    return np.where(neigh >= 0, d, np.inf)


def build_hierarchy_sig06(
    pos: np.ndarray,
    neigh: np.ndarray,
    *,
    lower_bound: int = 1000,
    max_levels: int = 10,
    seed: int = 0,
    verbose: bool = False,
    engine: str = "native",
    device="cuda",
) -> Hierarchy:
    """SIG06 hierarchy: MIS samples, nested points, 1-ring IDW weights."""
    dev = engine_device(engine, device)
    sampler = "native" if dev is None else "luby"
    pos = np.asarray(pos, dtype=np.float64)
    neigh = np.asarray(neigh, dtype=np.int32)
    timing = {"sampling": 0.0, "next_neighborhood": 0.0, "triangulation": 0.0}
    t_total = time.perf_counter()

    dof = [pos.shape[0]]
    levels: List[HierarchyLevel] = []
    level_pos, level_neigh = pos, neigh
    k = 0
    while dof[k] > lower_bound and k < max_levels:
        radius = float(np.cbrt(5.0)) * _avg_edge_length(level_pos, level_neigh)
        t0 = time.perf_counter()
        samples, _ = parallel_disk_sample(
            level_pos, level_neigh, radius, two_ring=False, seed=seed + k,
            engine=sampler, device=dev,
        )
        timing["sampling"] += time.perf_counter() - t0
        nc = len(samples)
        # Levels below lower_bound are kept (reference loop semantics,
        # multigrid_solver.cpp:103); only degenerate/stalled coarsenings
        # are rejected.
        if (nc < 8 and k > 0) or (k > 1 and nc / dof[k] > 0.9):
            break
        dof.append(nc)
        if verbose:
            print(f"sig06 level {k}: {dof[k]} -> {nc}")

        n = level_pos.shape[0]
        sample_map = np.full(n, -1, dtype=np.int64)
        sample_map[samples] = np.arange(nc)

        # Coarse graph: samples within each other's fine 1- and 2-ring.
        t0 = time.perf_counter()
        kk = level_neigh.shape[1]
        nbr1 = level_neigh[samples]                       # (Ns, K)
        safe1 = np.maximum(nbr1, 0)
        nbr2 = level_neigh[safe1].reshape(nc, -1)         # (Ns, K*K)
        nbr2 = np.where(np.repeat(nbr1 >= 0, kk, axis=1), nbr2, -1)
        cand = np.concatenate([nbr1, nbr2], axis=1)
        cand_map = np.where(cand >= 0, sample_map[np.maximum(cand, 0)], -1)
        rows = np.repeat(np.arange(nc, dtype=np.int64), cand_map.shape[1])
        colsn = cand_map.reshape(-1)
        m = (colsn >= 0) & (colsn != rows)
        keys = np.unique(rows[m] * nc + colsn[m])
        coarse_neigh = homogenize_edges(keys // nc, keys % nc, num_nodes=nc)
        timing["next_neighborhood"] += time.perf_counter() - t0

        coarse_pos = level_pos[samples].copy()

        # Prolongation: samples map to themselves; other vertices get
        # inverse-distance weights over sampled 1-ring neighbors.
        t0 = time.perf_counter()
        d = _edge_dists(level_pos, level_neigh)
        nbr_map = np.where(
            level_neigh >= 0, sample_map[np.maximum(level_neigh, 0)], -1
        )
        valid = nbr_map >= 0
        w = np.where(valid, 1.0 / np.maximum(d, 1e-8), 0.0)
        wsum = w.sum(axis=1)
        has_any = wsum > 0
        cols = np.where(valid, nbr_map, 0).astype(np.int32)
        wts = np.where(
            has_any[:, None], w / np.maximum(wsum, 1e-30)[:, None], 0.0
        )
        missing = ~has_any
        if missing.any():
            from scipy.spatial import KDTree

            owner = KDTree(coarse_pos).query(level_pos[missing])[1]
            cols[missing, 0] = owner
            wts[missing] = 0.0
            wts[missing, 0] = 1.0
        is_sample = sample_map >= 0
        cols[is_sample] = 0
        cols[is_sample, 0] = sample_map[is_sample]
        wts[is_sample] = 0.0
        wts[is_sample, 0] = 1.0
        timing["triangulation"] += time.perf_counter() - t0

        labels = cols[np.arange(n), np.argmax(wts, axis=1)]
        levels.append(
            HierarchyLevel(
                U=make_prolongation(cols, wts, nc),
                samples=samples,
                labels=labels.astype(np.int32),
                coarse_points=coarse_pos,
                coarse_neigh=coarse_neigh,
                stats=np.zeros(3, dtype=np.int64),
            )
        )
        level_pos, level_neigh = coarse_pos, coarse_neigh
        k += 1

    timing["levels"] = float(len(levels))
    timing["hierarchy"] = (time.perf_counter() - t_total) * 1000.0
    timing["n_vertices"] = float(pos.shape[0])
    return Hierarchy(dof, levels, pos, neigh, timing)


def build_hierarchy_ablation(
    pos: np.ndarray,
    neigh: np.ndarray,
    *,
    ratio: float = 8.0,
    lower_bound: int = 1000,
    max_levels: int = 10,
    num_points: int = 3,
    random_points: bool = False,
    nested: bool = False,
    seed: int = 0,
    verbose: bool = False,
    engine: str = "native",
    device="cuda",
) -> Hierarchy:
    """Ablation hierarchy: the main sampling/clustering, IDW weights over
    the ``num_points`` closest (or, with ``random_points``, seeded random)
    coarse neighbors instead of triangle selection."""
    dev = engine_device(engine, device)
    sampler = "native" if dev is None else "luby"
    pos = np.asarray(pos, dtype=np.float64)
    neigh = np.asarray(neigh, dtype=np.int32)
    timing = {"sampling": 0.0, "cluster": 0.0, "next_neighborhood": 0.0,
              "next_positions": 0.0, "triangle_selection": 0.0}
    t_total = time.perf_counter()
    rng = np.random.default_rng(seed)

    dof = [pos.shape[0]]
    levels: List[HierarchyLevel] = []
    level_pos, level_neigh = pos, neigh
    k = 0
    while dof[k] > lower_bound and k < max_levels:
        radius = float(np.cbrt(ratio)) * _avg_edge_length(level_pos, level_neigh)
        t0 = time.perf_counter()
        samples, _ = parallel_disk_sample(
            level_pos, level_neigh, radius, two_ring=True, seed=seed + k,
            engine=sampler, device=dev,
        )
        timing["sampling"] += time.perf_counter() - t0
        nc = len(samples)
        if nc < 8 and k > 0:
            break  # degenerate only; sub-lower_bound levels are kept
        dof.append(nc)
        if verbose:
            print(f"ablation level {k}: {dof[k]} -> {nc}")

        t0 = time.perf_counter()
        labels, _ = cluster_labels(level_pos, samples, level_neigh,
                                   engine=engine, device=dev)
        timing["cluster"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        coarse_neigh = _coarse_graph(labels, level_neigh, nc, engine)
        timing["next_neighborhood"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        coarse_pos = _coarse_positions(
            level_pos, labels, samples, coarse_neigh, nested
        )
        timing["next_positions"] += time.perf_counter() - t0

        # Weights: own cell + (num_points-1) closest/random coarse neighbors,
        # inverse-distance (multigrid_solver.cpp:1675-1716).
        t0 = time.perf_counter()
        n = level_pos.shape[0]
        nbr = coarse_neigh[labels]                        # (N, Kc)
        valid = nbr >= 0
        dq = np.linalg.norm(
            level_pos[:, None, :] - coarse_pos[np.maximum(nbr, 0)], axis=-1
        )
        if random_points:
            keys = np.where(valid, rng.random(nbr.shape), np.inf)
        else:
            keys = np.where(valid, dq, np.inf)
        npick = max(num_points - 1, 0)
        width = npick + 1
        cols = np.zeros((n, width), dtype=np.int32)
        dsel = np.zeros((n, width), dtype=np.float64)
        cols[:, 0] = labels
        dsel[:, 0] = np.linalg.norm(level_pos - coarse_pos[labels], axis=-1)
        picked_valid = np.zeros((n, width), dtype=bool)
        picked_valid[:, 0] = True
        if npick > 0:
            if npick >= nbr.shape[1]:
                order = np.argsort(keys, axis=1)[:, :npick]
            else:
                order = np.argpartition(keys, npick - 1, axis=1)[:, :npick]
            rsel = np.arange(n)[:, None]
            sel_nbr = nbr[rsel, order]
            sel_ok = np.isfinite(keys[rsel, order]) & (sel_nbr >= 0)
            cols[:, 1:] = np.where(sel_ok, sel_nbr, 0)
            dsel[:, 1:] = dq[rsel, order]
            picked_valid[:, 1:] = sel_ok
        w = np.where(picked_valid, 1.0 / np.maximum(dsel, 1e-8), 0.0)
        wts = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-30)
        timing["triangle_selection"] += time.perf_counter() - t0

        levels.append(
            HierarchyLevel(
                U=make_prolongation(cols, wts, nc),
                samples=samples,
                labels=labels,
                coarse_points=coarse_pos,
                coarse_neigh=coarse_neigh,
                stats=np.zeros(3, dtype=np.int64),
            )
        )
        level_pos, level_neigh = coarse_pos, coarse_neigh
        k += 1

    timing["levels"] = float(len(levels))
    timing["hierarchy"] = (time.perf_counter() - t_total) * 1000.0
    timing["n_vertices"] = float(pos.shape[0])
    return Hierarchy(dof, levels, pos, neigh, timing)
