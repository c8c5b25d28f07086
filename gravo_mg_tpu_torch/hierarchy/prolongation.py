"""Prolongation-weight assembly: native OpenMP sweep or batched geometry on
a device.

Counterpart of ``gravo_mg_tpu/hierarchy/prolongation.py``.  Reference
semantics (`gravomg/src/multigrid_solver.cpp:287-457`): each fine vertex
projects onto the candidate triangles of its Voronoi cell, taking
barycentric weights from the best containing triangle, else the best
"inside" edge, else inverse-distance weights over the 3 closest coarse
points.  The result is a row of <= 3 weights summing to 1.

* **native** (default): the C++ sweep (native/gravomg_native.cpp
  ``prolongation_weights_native``).
* **device**: every fine vertex tests **all** Kp = Kc(Kc-1)/2 neighbor
  pairs of its cell at once, a (B, Kp, 3) batched geometry with masked
  argmin selection, in torch on ``device``.  As in the JAX package, the
  best containing triangle is the argmin-distance one (the reference takes
  the first in list order, `:359-365`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..enums import Weighting
from ..sparse import resolve_device

_EPS = 1e-8
# Fine vertices per block times candidate pairs: bounds the (B, Kp, 3)
# temporaries (~30 of them, ~100 MB each in f32 at this cap).
PAIR_CAP = 1 << 23


# The geometry below decides branches by signs and argmins of f32 values,
# so each value is formed with explicit fused multiply-adds (``addcmul``),
# one way on every device and the way XLA's CPU backend forms the JAX
# package's: a dot as a chain of FMAs, a cross component a_i b_j - a_j b_i
# as fma(a_i, b_j, -(a_j b_i)), a norm as the square root of such a dot,
# rounded correctly (torch's f32 sqrt on the CPU is not: it is taken in f64,
# which rounds to the same f32 as an exact square root would).


def _dot(a, b):
    """Dot product over the last axis (of 3)."""
    out = a[..., 0] * b[..., 0]
    for i in range(1, a.shape[-1]):
        out = torch.addcmul(out, a[..., i], b[..., i])
    return out


def _norm(x):
    """2-norm over the last axis."""
    return torch.sqrt(_dot(x, x).double()).to(x.dtype)


def _cross(a, b):
    """Cross product over the last axis."""
    def comp(i, j):
        return torch.addcmul(-(a[..., j] * b[..., i]), a[..., i], b[..., j])

    return torch.stack([comp(1, 2), comp(2, 0), comp(0, 1)], -1)


def _pair_tables(kc: int, device):
    """Static pair enumeration tables for Kc neighbor slots: the slots
    (pi, pj) of each pair, and for each slot the pairs holding it and
    whether it is their first member."""
    pi, pj = np.triu_indices(kc, k=1)
    kp = pi.shape[0]
    pair_of_slot = np.zeros((kc, max(kc - 1, 1)), dtype=np.int64)
    is_a = np.zeros((kc, max(kc - 1, 1)), dtype=bool)
    counts = np.zeros(kc, dtype=np.int64)
    for t in range(kp):
        a, b = pi[t], pj[t]
        pair_of_slot[a, counts[a]] = t
        is_a[a, counts[a]] = True
        counts[a] += 1
        pair_of_slot[b, counts[b]] = t
        is_a[b, counts[b]] = False
        counts[b] += 1
    return tuple(torch.from_numpy(a).to(device)
                 for a in (pi.astype(np.int64), pj.astype(np.int64),
                           pair_of_slot, is_a))


def _inv_dist_weights(p, pts, valid=None):
    """Normalized inverse-distance weights (multigrid_solver.cpp:515-526)."""
    w = 1.0 / _norm(p[:, None, :] - pts).clamp_min(_EPS)
    if valid is not None:
        w = torch.where(valid, w, 0.0)
    return w / w.sum(1, keepdim=True).clamp_min(_EPS)


def _weights_block(
    p, c, rowid, Q, coarse_neigh, pair_adj, sample_of_label, tables,
    *, check_voronoi, nested, weighting,
):
    """Prolongation cols (B, 3) int32, weights (B, 3) float32 and branch
    stats (3,) for one block of fine vertices at positions ``p``, in cells
    ``c``, with row indices ``rowid``; ``tables`` are ``_pair_tables``."""
    B = p.shape[0]
    pi, pj, pair_of_slot, is_a = tables
    kp = pi.shape[0]
    zeros, ones = p.new_zeros(B), p.new_ones(B)

    nbr = coarse_neigh[c]                    # (B, Kc)
    valid_n = nbr >= 0
    nvalid = valid_n.sum(1)
    qc = Q[c]                                # (B, 3)

    # ---- pair (candidate triangle) geometry --------------------------------
    na, nb = nbr[:, pi], nbr[:, pj]          # (B, Kp)
    pair_ok = (na >= 0) & (nb >= 0)
    if check_voronoi:
        pair_ok &= pair_adj[c]
    qa = Q[na.clamp_min(0)]                  # (B, Kp, 3)
    qb = Q[nb.clamp_min(0)]
    e1 = qa - qc[:, None, :]
    e2 = qb - qc[:, None, :]
    nrm = _cross(e1, e2)
    nn = _norm(nrm)
    pair_ok &= nn > 1e-12
    nhat = nrm / nn.clamp_min(1e-30)[..., None]
    rel = p[:, None, :] - qc[:, None, :]
    dt = _dot(rel, nhat)                     # signed plane distance
    pp = p[:, None, :] - dt[..., None] * nhat
    dA = nn.clamp_min(1e-30)                 # (e1 x e2) . nhat
    b0 = _dot(_cross(qb - qa, pp - qa), nhat) / dA
    b1 = _dot(_cross(qc[:, None, :] - qb, pp - qb), nhat) / dA
    b2 = 1.0 - b0 - b1

    def first_min(d):
        """(index, found) of each row's first minimum; no pair, none."""
        if d.shape[1] == 0:   # argmin over an empty axis raises
            return d.new_zeros(B, dtype=torch.int64), torch.zeros_like(valid_n[:, 0])
        best = d.argmin(1, keepdim=True)
        return best, torch.isfinite(d.gather(1, best)[:, 0])

    def take(arr, idx):
        if arr.shape[1] == 0:
            return arr.new_zeros(B)
        return arr.gather(1, idx.view(B, 1))[:, 0]

    hit = pair_ok & (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
    tbest, tri_found = first_min(torch.where(hit, dt.abs(), torch.inf))
    tri_cols = torch.stack([c, take(na, tbest), take(nb, tbest)], 1)
    tri_bary = torch.stack([take(b0, tbest), take(b1, tbest), take(b2, tbest)], 1)

    # ---- edge fallback ------------------------------------------------------
    # Edge (c, n) is a candidate if some valid pair contains slot n and the
    # barycentric tests of every such pair leave the edge "inside"
    # (reference insideEdge map, multigrid_solver.cpp:489-500).
    qn = Q[nbr.clamp_min(0)]                 # (B, Kc, 3)
    e = qn - qc[:, None, :]
    proj_t = _dot(rel, e) / _dot(e, e).clamp_min(_EPS * _EPS)
    if kp:
        oka = (b0 >= 0) & (b1 >= 0)          # wedge test toward first member
        okb = (b0 >= 0) & (b2 >= 0)
        vp = pair_ok[:, pair_of_slot]        # (B, Kc, Kc-1)
        wedge = torch.where(is_a, oka[:, pair_of_slot], okb[:, pair_of_slot])
        edge_valid = vp.any(2) & ~(vp & ~wedge).any(2) & valid_n
    else:
        edge_valid = torch.zeros_like(valid_n)
    perp = _norm(rel - proj_t[..., None] * e)
    ebest, edge_found = first_min(torch.where(edge_valid, perp, torch.inf))
    n_edge = take(nbr, ebest)
    t_edge = take(proj_t, ebest).clamp(0.0, 1.0)

    # ---- closest-3 fallback -------------------------------------------------
    dist_s = torch.where(valid_n, _norm(p[:, None, :] - qn), torch.inf)
    # The two nearest slots, ties to the lower slot (lax.top_k's order).
    order = torch.sort(dist_s, dim=1, stable=True).indices
    f1 = take(nbr, order[:, 0]).clamp_min(0)
    f2 = take(nbr, order[:, min(1, order.shape[1] - 1)])
    # If a cell has exactly 2 valid neighbors the 2nd pick duplicates; keep
    # it valid by falling back to the first neighbor (weight merges).
    f2 = torch.where(f2 >= 0, f2, f1)
    fb_cols = torch.stack([c, f1, f2], 1)
    fb_w = _inv_dist_weights(p, Q[fb_cols])

    # ---- per-case weighting schemes ----------------------------------------
    if weighting == int(Weighting.BARYCENTRIC):
        tri_w = tri_bary
    elif weighting == int(Weighting.UNIFORM):
        tri_w = torch.full((B, 3), 1.0 / 3.0, dtype=p.dtype, device=p.device)
    else:
        tri_w = _inv_dist_weights(p, Q[tri_cols])

    def two_point_weights(other_col, w2):
        cols = torch.stack([c, other_col.clamp_min(0), c], 1)
        if weighting == int(Weighting.UNIFORM):
            w = torch.stack([ones * 0.5, ones * 0.5, zeros], 1)
        elif weighting == int(Weighting.INVDIST):
            valid = torch.tensor([True, True, False], device=p.device)
            w = _inv_dist_weights(p, Q[cols], valid.expand(B, 3))
        else:
            w = torch.stack([1.0 - w2, w2, zeros], 1)
        return cols, w

    # Single-neighbor case: project onto the segment c -> first neighbor
    # (multigrid_solver.cpp:309-338).
    n0 = nbr[:, 0]
    e0 = Q[n0.clamp_min(0)] - qc
    t0 = _dot(p - qc, e0) / _dot(e0, e0).clamp_min(_EPS * _EPS)
    single_cols, single_w = two_point_weights(n0, t0.clamp(0.0, 1.0))
    edge_cols, edge_w = two_point_weights(n_edge, t_edge)

    one_cols = torch.stack([c, c, c], 1)
    one_w = torch.stack([ones, zeros, zeros], 1)

    # ---- case selection (priority order mirrors the reference) -------------
    def sel(cond, a_cols, a_w, b_cols, b_w):
        cond = cond[:, None]
        return torch.where(cond, a_cols, b_cols), torch.where(cond, a_w, b_w)

    cols, w = sel(edge_found, edge_cols, edge_w, fb_cols, fb_w)
    cols, w = sel(tri_found, tri_cols, tri_w, cols, w)
    cols, w = sel(nvalid == 1, single_cols, single_w, cols, w)
    cols, w = sel(nvalid == 0, one_cols, one_w, cols, w)
    if nested:
        cols, w = sel(sample_of_label[c] == rowid, one_cols, one_w, cols, w)

    live = nvalid > 1
    stats = torch.stack([
        (tri_found & live).sum(),
        (~tri_found & edge_found & live).sum(),
        (~tri_found & ~edge_found & live).sum(),
    ])
    return cols.to(torch.int32), w, stats


def _pair_adjacency(coarse_neigh: np.ndarray) -> np.ndarray:
    """pair_adj[c, t]: whether the t-th neighbor pair (slots pi[t], pj[t])
    of cell c is an edge of the coarse graph (the reference's
    `checkVoronoi` set lookup, multigrid_solver.cpp:266), on the host."""
    nc, kc = coarse_neigh.shape
    pi, pj = np.triu_indices(kc, k=1)
    pair_adj = np.zeros((nc, pi.shape[0]), dtype=bool)
    if not pi.shape[0]:
        return pair_adj
    chunk = max(1, (1 << 26) // max(kc * kc * kc, 1))
    for s in range(0, nc, chunk):
        e = min(s + chunk, nc)
        blk = coarse_neigh[s:e]                             # (B, Kc)
        ring = coarse_neigh[np.maximum(blk, 0)]             # (B, Kc, Kc)
        ring = np.where((blk >= 0)[:, :, None], ring, -2)
        # adj[b, s1, s2] = cn[blk[b,s1]] contains blk[b,s2]
        adj = (ring[:, :, None, :] == blk[:, None, :, None]).any(-1)
        adj &= (blk >= 0)[:, None, :]
        pair_adj[s:e] = adj[:, pi, pj]
    return pair_adj


def prolongation_weights(
    fine_pos: np.ndarray,
    labels: np.ndarray,
    coarse_pos: np.ndarray,
    coarse_neigh: np.ndarray,
    *,
    check_voronoi: bool = True,
    nested: bool = False,
    samples: np.ndarray | None = None,
    weighting: int = 0,
    block: int = 65536,
    engine: str = "native",
    device="cuda",
):
    """Compute (cols (N, 3) int32, weights (N, 3) float32, stats) for one
    hierarchy level; stats (int64) counts (triangles, edges, fallbacks).

    ``engine="device"`` runs the batched geometry on ``device`` over blocks
    of at most ``block`` fine vertices and ``PAIR_CAP`` candidate pairs.
    """
    if engine == "native":
        from ..native import prolongation_weights_cpp

        return prolongation_weights_cpp(
            fine_pos, labels, coarse_pos, coarse_neigh,
            check_voronoi, nested, samples if nested else None, int(weighting),
        )
    if engine != "device":
        raise ValueError(f"engine must be 'native' or 'device', got {engine!r}")
    dev = resolve_device(device)
    n = fine_pos.shape[0]
    nc, kc = coarse_neigh.shape
    pair_adj = _pair_adjacency(coarse_neigh) if check_voronoi else None
    tables = _pair_tables(kc, dev)
    kp = tables[0].shape[0]

    def upload(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    Q = upload(coarse_pos, np.float32)
    cn = upload(coarse_neigh, np.int64)
    ek = upload(pair_adj, bool) if check_voronoi else None
    sol = upload(samples if samples is not None else np.zeros(nc), np.int64)
    P = upload(fine_pos, np.float32)
    L = upload(labels, np.int64)

    out_cols = torch.empty((n, 3), dtype=torch.int32, device=dev)
    out_w = torch.empty((n, 3), dtype=torch.float32, device=dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    step = max(1, min(block, PAIR_CAP // max(kp, 1)))
    for start in range(0, n, step):
        end = min(start + step, n)
        cols_b, w_b, st_b = _weights_block(
            P[start:end], L[start:end],
            torch.arange(start, end, device=dev), Q, cn, ek, sol, tables,
            check_voronoi=check_voronoi, nested=nested,
            weighting=int(weighting),
        )
        out_cols[start:end] = cols_b
        out_w[start:end] = w_b
        stats += st_b
    return out_cols.cpu().numpy(), out_w.cpu().numpy(), stats.cpu().numpy()
