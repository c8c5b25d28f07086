"""Graph-Voronoi clustering: native multi-source Dijkstra or Bellman-Ford
label propagation on a device.

Counterpart of ``gravo_mg_tpu/hierarchy/cluster.py``: the reference's
``constructDijkstraWithCluster`` (gravomg/src/multigrid_solver.cpp:1015-1056)
labels every fine vertex with its nearest coarse sample.

* **native** (default): exact priority-queue multi-source Dijkstra in C++
  (native/gravomg_native.cpp ``dijkstra_cluster``).
* **device**: every vertex repeatedly takes the minimum of
  ``D[j] + d(i, j)`` over its neighbors and adopts the label of the first
  argmin; it converges to the exact multi-source shortest path in
  O(cluster hop-radius) rounds, run in torch on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..sparse import resolve_device
from .sampling import CHECK_EVERY, edge_lengths_np, graph_tensors


def _bellman_ford(D0, label0, neigh, dist, max_rounds=64):
    """Jacobi label propagation from (D0, label0) until nothing improves or
    ``max_rounds``.  Returns (D, label, rounds), ``rounds`` being what the
    reference's loop runs: the rounds that improved something, plus the one
    that found nothing (it reads the flag every round; here it is read
    every CHECK_EVERY rounds and the improving rounds are counted on the
    device)."""
    safe_nb = neigh.clamp_min(0)
    valid = neigh >= 0
    D, label = D0, label0
    improving = torch.zeros((), dtype=torch.int64, device=D.device)
    for r in range(max_rounds):
        cand = torch.where(valid, D[safe_nb] + dist, torch.inf)    # (N, K)
        best = cand.argmin(1, keepdim=True)
        bestD = cand.gather(1, best)[:, 0]
        improved = bestD < D
        nb_label = label[safe_nb.gather(1, best)[:, 0]]
        D = torch.where(improved, bestD, D)
        label = torch.where(improved, nb_label, label)
        changed = improved.any()
        improving += changed
        if (r + 1) % CHECK_EVERY == 0 and not bool(changed):
            break
    return D, label, min(int(improving) + 1, max_rounds)


def cluster_labels(
    pos: np.ndarray,
    samples: np.ndarray,
    neigh,
    max_rounds: int = 256,
    dist=None,
    *,
    engine: str = "native",
    device="cuda",
    rounds: list | None = None,
):
    """Label every vertex with its nearest sample (graph distance).

    Returns ``(labels, D)`` where labels[i] in [0, len(samples)) and D is
    the graph distance to the owning sample.  Vertices no sample reaches
    (disconnected leftovers) take the Euclidean-nearest sample.
    ``engine="device"`` runs at most ``max_rounds`` Bellman-Ford rounds on
    ``device`` and appends the rounds it ran to ``rounds`` when that is a
    list; ``neigh`` and ``dist`` may then already be tensors on ``device``.
    """
    if engine not in ("native", "device"):
        raise ValueError(f"engine must be 'native' or 'device', got {engine!r}")
    n = pos.shape[0]
    if dist is None:
        dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
    if engine == "native":
        from ..native import dijkstra_cluster_native

        label, D = dijkstra_cluster_native(neigh, dist, samples)
        unreached = label < 0
    else:
        device = resolve_device(device)
        neigh_t, dist_t = graph_tensors(neigh, dist, device)
        D0 = np.full(n, np.inf, dtype=np.float32)
        D0[samples] = 0.0
        label0 = np.zeros(n, dtype=np.int32)
        label0[samples] = np.arange(len(samples), dtype=np.int32)
        D, label, ran = _bellman_ford(
            torch.from_numpy(D0).to(device), torch.from_numpy(label0).to(device),
            neigh_t, dist_t, max_rounds=max_rounds,
        )
        D, label = D.cpu().numpy(), label.cpu().numpy()
        if rounds is not None:
            rounds.append(ran)
        unreached = ~np.isfinite(D)
    if unreached.any():
        from scipy.spatial import KDTree

        tree = KDTree(pos[samples])
        d_euc, owner = tree.query(pos[unreached])
        label[unreached] = owner
        D[unreached] = d_euc
    return label, D
