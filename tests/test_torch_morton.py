"""The port's Morton reordering (``gravo_mg_tpu_torch.utils.morton``)
equals the JAX package's on seeded random positions and neighbor arrays
(exactly: both are the same integer arithmetic in numpy)."""

import numpy as np
import pytest

from gravo_mg_tpu.utils import morton as ref
from gravo_mg_tpu_torch.utils import morton


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 500), (2, 20000)])
def test_morton_matches_reference(seed, n):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((n, 3)) * rng.uniform(0.1, 100.0, 3)
    key = morton.morton_key(pos)
    assert key.dtype == np.uint64
    assert np.array_equal(key, ref.morton_key(pos))
    perm = morton.morton_order(pos)
    assert np.array_equal(perm, ref.morton_order(pos))
    assert np.array_equal(np.sort(perm), np.arange(n))
    neigh = rng.integers(0, n, (n, 7))
    neigh[rng.random((n, 7)) < 0.3] = -1          # padding
    got = morton.relabel_neighbors(neigh, perm)
    assert np.array_equal(got, ref.relabel_neighbors(neigh, perm))
    assert np.array_equal(got < 0, neigh[perm] < 0)


def test_morton_flat_axis_and_locality():
    """A zero-extent axis does not divide by zero, and the Z-order of a
    shuffled grid puts spatial neighbours at nearby indices."""
    g = np.stack(np.meshgrid(np.arange(64), np.arange(64), indexing="ij"), -1)
    pos = np.concatenate([g.reshape(-1, 2), np.zeros((64 * 64, 1))], 1)
    pos = pos[np.random.default_rng(3).permutation(len(pos))]
    perm = morton.morton_order(pos)
    assert np.array_equal(perm, ref.morton_order(pos))
    step = np.abs(np.diff(pos[perm], axis=0)).sum(1)
    assert np.median(step) == 1.0
