"""Spatial (Morton / Z-order) vertex reordering.

Counterpart of ``gravo_mg_tpu/utils/morton.py`` (numpy, the same
functions and results).  Every device layout of the solver (ShuffleEll
slot tables, DiagEll diagonal runs, the halo row partition) keys its
padding and communication volume to index locality: consecutive vertex
indices should be spatially near, so that a group of 128 output rows
sources from a handful of 128-wide input blocks.  Mesh generators and
scan pipelines often emit raster or random orders, which pads the finest
restriction U^T many times over and grows each partition's halo.

``morton_order`` quantizes positions to a 21-bit lattice per axis and
sorts by interleaved bits, a space-filling curve that restores locality
for any input order in O(n log n) host time.

The solver has no reordering option: callers (the experiments) permute
positions with ``pos[perm]``, the neighbor array with
:func:`relabel_neighbors`, and their operators, right-hand sides and
solutions themselves.
"""

from __future__ import annotations

import numpy as np


def _part1by2(x: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of x so there are 2 zero bits between each
    (the Morton bit-smear, vectorized on uint64)."""
    x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
    x = (x | (x << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    x = (x | (x << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    x = (x | (x << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    x = (x | (x << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    x = (x | (x << np.uint64(2))) & np.uint64(0x1249249249249249)
    return x


def morton_key(pos: np.ndarray) -> np.ndarray:
    """(n,) uint64 Morton keys of (n, 3) positions (21 bits/axis)."""
    p = np.asarray(pos, dtype=np.float64)
    lo = p.min(axis=0)
    span = p.max(axis=0) - lo
    span[span <= 0] = 1.0
    q = ((p - lo) / span * ((1 << 21) - 1)).astype(np.uint64)
    return (
        _part1by2(q[:, 0])
        | (_part1by2(q[:, 1]) << np.uint64(1))
        | (_part1by2(q[:, 2]) << np.uint64(2))
    )


def morton_order(pos: np.ndarray) -> np.ndarray:
    """Permutation ``perm`` sorting vertices along the Z-curve:
    ``pos[perm]`` is spatially coherent.  Stable, deterministic."""
    return np.argsort(morton_key(pos), kind="stable")


def relabel_neighbors(neigh: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Re-index a padded (n, maxdeg) neighbor array (pad = -1) so row j
    of the result lists the NEW ids of vertex perm[j]'s neighbors."""
    neigh = np.asarray(neigh)
    n = neigh.shape[0]
    inv = np.empty(n, dtype=neigh.dtype)
    inv[perm] = np.arange(n, dtype=neigh.dtype)
    out = neigh[perm]
    valid = out >= 0
    out = np.where(valid, inv[np.where(valid, out, 0)], out)
    return np.ascontiguousarray(out)
