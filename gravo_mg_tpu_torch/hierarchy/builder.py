"""Hierarchy construction (host, native C++).

Counterpart of ``gravo_mg_tpu/hierarchy/builder.py`` on its native path,
mirroring the per-level pipeline of the reference's
``constructProlongation`` (`gravomg/src/multigrid_solver.cpp:62-469`):
radius from average edge length -> coarse sampling -> graph-Voronoi
clustering -> coarse graph / positions -> prolongation weights -> U_k,
looping until ``DoF <= lower_bound`` or ``max_levels``.  Given the same
seed it produces the same hierarchy as the reference, bit for bit.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np

from ..enums import Sampling, Weighting
from ..sparse import Prolongation, make_prolongation
from ..utils.neighbors import homogenize_edges, neighbors_to_edges
from .cluster import cluster_labels
from .prolongation import prolongation_weights
from .sampling import (
    edge_lengths_np,
    farthest_point_sample,
    parallel_disk_sample,
    poisson_disk_sample,
    random_sample,
)


@dataclasses.dataclass
class HierarchyLevel:
    """One coarsening step (level k -> k+1) plus introspection data."""

    U: Prolongation                 # DoF[k] x DoF[k+1]
    samples: np.ndarray             # fine indices chosen as coarse points
    labels: np.ndarray              # nearestSource: fine -> coarse cluster
    coarse_points: np.ndarray       # (DoF[k+1], 3)
    coarse_neigh: np.ndarray        # (DoF[k+1], Kc) padded -1
    stats: np.ndarray               # [triangle, edge, fallback] counts
    # Per-cluster averaged unit normals (when build_hierarchy got normals).
    coarse_nrm: Optional[np.ndarray] = None
    # Graph-Voronoi distance of each fine vertex to its cluster seed,
    # retained only when build_hierarchy runs with debug=True.
    cluster_dist: Optional[np.ndarray] = None


@dataclasses.dataclass
class Hierarchy:
    """Full multigrid hierarchy for one mesh/point cloud."""

    dof: List[int]
    levels: List[HierarchyLevel]
    points: np.ndarray
    neigh: np.ndarray
    timing: dict

    @property
    def num_levels(self) -> int:
        return len(self.levels)

    @property
    def prolongations(self) -> List[Prolongation]:
        return [lvl.U for lvl in self.levels]


def _coarse_graph(labels: np.ndarray, neigh: np.ndarray, nc: int) -> np.ndarray:
    """Coarse neighbor array: cells c1~c2 iff a fine edge crosses them.

    Parity: multigrid_solver.cpp:177-208 (minus the inert self column).
    """
    from ..native import unique_i64

    ii, jj = neighbors_to_edges(neigh)
    ci = labels[ii].astype(np.int64)
    cj = labels[jj].astype(np.int64)
    m = ci != cj
    keys = unique_i64(ci[m] * nc + cj[m])
    return homogenize_edges(keys // nc, keys % nc, num_nodes=nc)


def _coarse_positions(
    pos: np.ndarray,
    labels: np.ndarray,
    samples: np.ndarray,
    coarse_neigh: np.ndarray,
    nested: bool,
) -> np.ndarray:
    """Voronoi-cell barycenters (or sample positions when nested).

    Parity: multigrid_solver.cpp:214-241 including the singleton-cell rule
    (average the sample with its neighboring cells' samples).
    """
    nc = len(samples)
    if nested:
        return pos[samples].copy()
    sums = np.zeros((nc, 3), dtype=np.float64)
    np.add.at(sums, labels, pos)
    sizes = np.bincount(labels, minlength=nc)
    out = sums / np.maximum(sizes, 1)[:, None]
    singles = np.nonzero(sizes <= 1)[0]
    for c in singles:
        nbrs = coarse_neigh[c]
        nbrs = nbrs[nbrs >= 0]
        out[c] = (pos[samples[c]] + pos[samples[nbrs]].sum(axis=0)) / (
            len(nbrs) + 1.0
        )
    return out


def _coarse_normals(normals, labels, nc: int):
    """Cluster-averaged unit normals (see HierarchyLevel.coarse_nrm)."""
    sums = np.zeros((nc, 3), dtype=np.float64)
    np.add.at(sums, labels, normals)
    nrm = np.linalg.norm(sums, axis=1, keepdims=True)
    return sums / np.maximum(nrm, 1e-30)


def build_hierarchy(
    pos: np.ndarray,
    neigh: np.ndarray,
    *,
    ratio: float = 8.0,
    lower_bound: int = 1000,
    max_levels: int = 10,
    sampling_strategy: int = Sampling.FASTDISK,
    weighting: int = Weighting.BARYCENTRIC,
    check_voronoi: bool = True,
    nested: bool = False,
    normals: Optional[np.ndarray] = None,
    seed: int = 0,
    verbose: bool = False,
    debug: bool = False,
) -> Hierarchy:
    """Build the graph-Voronoi multigrid hierarchy."""
    pos = np.asarray(pos, dtype=np.float64)
    neigh = np.asarray(neigh, dtype=np.int32)
    level_nrm = (
        np.asarray(normals, dtype=np.float64) if normals is not None else None
    )
    timing = {
        "sampling": 0.0, "cluster": 0.0, "next_neighborhood": 0.0,
        "next_positions": 0.0, "triangle_selection": 0.0,
        "edge_lengths": 0.0, "prolongation_assembly": 0.0,
    }
    t_total = time.perf_counter()

    dof = [pos.shape[0]]
    levels: List[HierarchyLevel] = []
    level_pos, level_neigh = pos, neigh
    k = 0
    while dof[k] > lower_bound and k < max_levels:
        # One edge-length table per level, shared by the radius rule,
        # sampler and clustering.
        t0 = time.perf_counter()
        edge_d = edge_lengths_np(level_pos, level_neigh)
        timing["edge_lengths"] += time.perf_counter() - t0
        finite = np.isfinite(edge_d) & (edge_d > 0)
        avg_e = float(edge_d[finite].mean()) if finite.any() else 1.0
        radius = float(np.cbrt(ratio)) * avg_e

        t0 = time.perf_counter()
        strat = Sampling(sampling_strategy)
        if strat in (Sampling.FASTDISK, Sampling.MIS):
            # Greedy disk sampling in a seeded random visit order, with the
            # radius calibrated to deliver the requested coarsening ratio
            # (a documented deviation of the reference package: index-order
            # sweeps on raster-ordered meshes under-coarsen; sample counts
            # scale ~1/r^2, so 1-2 radius adjustments land within ~10%).
            two_ring = strat == Sampling.FASTDISK
            rng = np.random.default_rng(seed + k)
            order = rng.permutation(dof[k]).astype(np.int32)
            target = max(dof[k] / ratio, 1.0)
            for _ in range(3):
                samples, _ = parallel_disk_sample(
                    level_pos, level_neigh, radius, two_ring=two_ring,
                    dist=edge_d, order=order,
                )
                nc = len(samples)
                if nc <= 1.1 * target or nc <= max(lower_bound, 8):
                    break
                # 2-hop marking caps the reachable ball; don't overshoot.
                radius *= min(float(np.sqrt(nc / target)), 1.6)
        elif strat == Sampling.RANDOM:
            samples = random_sample(dof[k], int(dof[k] / ratio), seed=seed + k)
        elif strat == Sampling.POISSONDISK:
            samples = poisson_disk_sample(level_pos, radius, seed=seed + k)
        elif strat == Sampling.FPS:
            samples = farthest_point_sample(
                level_pos, level_neigh, int(dof[k] / ratio), dist=edge_d
            )
        else:
            raise ValueError(f"unknown sampling strategy {sampling_strategy}")
        timing["sampling"] += time.perf_counter() - t0

        # Reference semantics (multigrid_solver.cpp:103): coarsen while
        # DoF[k] > lowBound; only degenerate samplings are rejected.
        if len(samples) < 8 and k > 0:
            break
        nc = len(samples)
        dof.append(nc)
        if verbose:
            print(f"level {k}: {dof[k]} -> {nc} (radius {radius:.4g})")

        t0 = time.perf_counter()
        labels, _dist = cluster_labels(
            level_pos, samples, level_neigh, dist=edge_d
        )
        timing["cluster"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        coarse_neigh = _coarse_graph(labels, level_neigh, nc)
        timing["next_neighborhood"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        coarse_pos = _coarse_positions(
            level_pos, labels, samples, coarse_neigh, nested
        )
        timing["next_positions"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        cols, w, stats = prolongation_weights(
            level_pos, labels, coarse_pos, coarse_neigh,
            check_voronoi=check_voronoi, nested=nested, samples=samples,
            weighting=weighting,
        )
        timing["triangle_selection"] += time.perf_counter() - t0

        coarse_nrm = (
            _coarse_normals(level_nrm, labels, nc)
            if level_nrm is not None else None
        )
        t0 = time.perf_counter()
        U_level = make_prolongation(cols, w, nc)
        timing["prolongation_assembly"] += time.perf_counter() - t0
        levels.append(
            HierarchyLevel(
                U=U_level,
                samples=samples,
                labels=labels,
                coarse_points=coarse_pos,
                coarse_neigh=coarse_neigh,
                stats=stats,
                coarse_nrm=coarse_nrm,
                cluster_dist=(
                    np.asarray(_dist, dtype=np.float64) if debug else None
                ),
            )
        )
        level_pos, level_neigh = coarse_pos, coarse_neigh
        level_nrm = coarse_nrm
        k += 1

    timing["levels"] = float(len(levels))
    timing["hierarchy"] = (time.perf_counter() - t_total) * 1000.0
    timing["n_vertices"] = float(pos.shape[0])
    return Hierarchy(dof, levels, pos, neigh, timing)
