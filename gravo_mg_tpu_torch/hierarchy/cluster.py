"""Graph-Voronoi clustering by native multi-source Dijkstra.

Counterpart of ``gravo_mg_tpu/hierarchy/cluster.py`` on its native path:
the reference's ``constructDijkstraWithCluster``
(gravomg/src/multigrid_solver.cpp:1015-1056) labels every fine vertex with
its nearest coarse sample (native/gravomg_native.cpp ``dijkstra_cluster``).
"""

from __future__ import annotations

import numpy as np


def cluster_labels(
    pos: np.ndarray,
    samples: np.ndarray,
    neigh: np.ndarray,
    dist: np.ndarray | None = None,
):
    """Label every vertex with its nearest sample (graph distance).

    Returns ``(labels, D)`` where labels[i] in [0, len(samples)) and D is
    the graph distance to the owning sample.  Vertices no sample reaches
    (disconnected leftovers) take the Euclidean-nearest sample.
    """
    from ..native import dijkstra_cluster_native
    from .sampling import edge_lengths_np

    if dist is None:
        dist = edge_lengths_np(np.asarray(pos, np.float64), neigh)
    label, D = dijkstra_cluster_native(neigh, dist, samples)
    unreached = label < 0
    if unreached.any():
        from scipy.spatial import KDTree

        tree = KDTree(pos[samples])
        d_euc, owner = tree.query(pos[unreached])
        label[unreached] = owner
        D[unreached] = d_euc
    return label, D
