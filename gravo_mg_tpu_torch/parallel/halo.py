"""Distributed multigrid with a static halo exchange, on ``torch.distributed``.

Counterpart of ``gravo_mg_tpu/parallel/halo.py``.  The rows of every level
operator, both transfers and the mass matrix are block-partitioned over
``D`` partitions (:class:`SolverMesh`); each rank holds
``D / world_size`` consecutive ones.

* Host partitioner (once per context, :func:`_build_dist_op`): for each
  partition the off-partition columns it touches form its sorted **halo
  set**; each block is split by slot into an **interior part** (columns
  inside the partition) and a **halo part** (columns in the halo buffer),
  both in shuffle-ELL form, and the exchange plan groups each halo set by
  owner into ring shifts.  Given the same csr it produces the reference's
  arrays bit for bit.
* Device apply (:class:`PartitionedOp`): a rank's partitions share KP and
  S, so they are stacked into ONE ShuffleEll per part, and each apply is
  two launches of the ShuffleEll kernel whatever the number of partitions:
  post the exchange, interior SpMV (reads only local blocks), wait, halo
  SpMV on the received buffer.
* Exchange: for ring shift ``s`` partition ``i`` gathers
  ``x_loc[send_idx[i]]`` and sends it to ``(i + s) % D``, which scatters it
  to ``halo[recv_pos]`` (``jax.lax.ppermute`` semantics; padding goes to
  the dump slot ``H``).  Between partitions of one rank the transfer is a
  device-local gather/scatter; between ranks it is one
  ``dist.batch_isend_irecv`` of every rank's point-to-point transfers.
* The cycle is the single-device one (``solver/multigrid.py``) over the
  partitioned operators; the coarsest level all-gathers its right-hand
  side and applies the replicated, identity-padded coarse inverse; the
  residual check all-reduces per-column sums.

The local vector of a level is this rank's partitions laid end to end,
each padded from ``nloc`` rows to the ShuffleEll row extent ``S * 128``
(``stride``), so operator outputs need no compaction; padded rows stay
exactly zero.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..solver.multigrid import (
    LevelOps,
    _full_fp32_matmul,
    cycle_step,
    deflation_alpha,
)
from ..sparse import ShuffleEll, ShuffleTransfer, _shuffle_layout, numpy_dtype, spmv


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def partition_rows(n: int, D: int) -> Tuple[int, int]:
    """Rows per partition of an ``n``-row level over ``D`` partitions
    (128-aligned, so the interior part gathers straight from local
    blocks) and its local stride (the ShuffleEll row extent)."""
    nloc = _round_up(n, 128 * D) // D
    return nloc, _round_up(nloc, 8 * 128)


@dataclasses.dataclass
class SolverMesh:
    """A 1-D row partitioning over ``world_size`` ranks.

    ``n_partitions`` row blocks, numbered process-major: this rank holds
    ``local_range``.  ``distributed`` says whether the collectives go
    through ``torch.distributed`` (a mesh from
    :func:`multihost.global_row_mesh`) or the single process holds every
    partition without a process group (:func:`make_solver_mesh`).
    """

    n_partitions: int
    device: torch.device
    rank: int = 0
    world_size: int = 1
    distributed: bool = False
    partitions_per_node: int = 0   # 0: every partition on one node

    def __post_init__(self):
        if self.n_partitions % self.world_size:
            raise ValueError("n_partitions must be a multiple of world_size")

    @property
    def partitions_per_rank(self) -> int:
        return self.n_partitions // self.world_size

    @property
    def local_range(self) -> Tuple[int, int]:
        p = self.partitions_per_rank
        return self.rank * p, (self.rank + 1) * p

    def rank_of(self, part: int) -> int:
        return part // self.partitions_per_rank


def make_solver_mesh(n_partitions: int, device="cuda") -> SolverMesh:
    """One process holding all ``n_partitions`` row blocks on one device
    (the counterpart of the reference's single-process
    ``parallel/dist.py::make_solver_mesh``).  On a GPU every apply runs
    the kernels; CUDA without a GPU raises."""
    from ..sparse import resolve_device

    return SolverMesh(int(n_partitions), resolve_device(device))


@dataclasses.dataclass
class DistOp:
    """One row-partitioned operator as host arrays stacked over the ``D``
    partitions (the reference's DistOp, before it is put on devices).

    ``q/r/v`` are the interior slots (source blocks inside the partition),
    ``qh/rh/vh`` the halo slots (sourcing the halo buffer).  ``steps``
    holds one ``(shift, send_idx (D, Hs), recv_pos (D, Hs))`` per ring
    shift with traffic: partition ``d`` gathers ``x_local[send_idx[d]]``
    for ``(d + shift) % D``, which scatters it to ``halo[recv_pos]``.
    """

    q: np.ndarray          # (D, KP, S) int32
    r: np.ndarray          # (D, KP, S, 128) int8
    v: np.ndarray          # (D, KP, S, 128)
    qh: np.ndarray         # (D, KPH, S) int32 (KPH may be 0)
    rh: np.ndarray         # (D, KPH, S, 128) int8
    vh: np.ndarray         # (D, KPH, S, 128)
    steps: Tuple
    rows_local: int
    cols_local: int
    halo: int              # real halo entries (max over partitions)
    halo_pad: int          # halo buffer length, multiple of 128, > halo


def _build_dist_op(A_csr, D: int, rl: int, cl: int, dtype,
                   local_devices: int = 0) -> DistOp:
    """Partition a global csr operator into per-partition halo-remapped
    shuffle-ELL blocks (host numpy, once per context).

    ``local_devices`` (partitions per node) orders the exchange steps
    inter-node first; 0 means one node (order by |shift|).  Values are
    written straight in ``dtype`` (a numpy or torch dtype), which rounds
    each entry exactly as the reference's f64-then-cast does.
    """
    if isinstance(dtype, torch.dtype):
        dtype = numpy_dtype(dtype)
    np_dtype = np.dtype(dtype)
    if cl % 128:
        raise ValueError("the per-partition column block must be 128-aligned")
    A = A_csr.tocsr()
    A.sum_duplicates()
    nr, nc = A.shape
    halo_cols: List[np.ndarray] = []
    blocks = []
    for d in range(D):
        r0, r1 = d * rl, min((d + 1) * rl, nr)
        blk = A[r0:r1].tocoo() if r1 > r0 else None
        if blk is None or blk.nnz == 0:
            blocks.append((np.zeros(0, np.int64),) * 2 + (np.zeros(0),))
            halo_cols.append(np.zeros(0, np.int64))
            continue
        rows = blk.row.astype(np.int64)
        cols = blk.col.astype(np.int64)
        local = (cols >= d * cl) & (cols < (d + 1) * cl)
        halo_cols.append(np.unique(cols[~local]))
        blocks.append((rows, cols, blk.data))
    H = max((len(h) for h in halo_cols), default=0)
    # 128-aligned, with at least one spare slot for the exchange's padding.
    H_pad = _round_up(H + 1, 128) if H else 0

    layouts = []
    kp_max, kph_max, s_uniform = 1, 0, None
    for d in range(D):
        rows, cols, data = blocks[d]
        local = (cols >= d * cl) & (cols < (d + 1) * cl)
        kp, s, q, pos = _shuffle_layout(rows[local], cols[local] - d * cl, rl, cl)
        if s_uniform is None:
            s_uniform = s
        if s != s_uniform:
            raise AssertionError("row-group count differs between partitions")
        kp_max = max(kp_max, kp)
        if H:
            hmap = np.searchsorted(halo_cols[d], cols[~local])
            kph, _, qh, posh = _shuffle_layout(rows[~local], hmap, rl, H_pad)
            kph_max = max(kph_max, kph if len(hmap) else 0)
        else:
            kph, qh, posh, hmap = 0, None, None, None
        layouts.append((kp, q, pos, cols[local] - d * cl, data[local],
                        kph, qh, posh, hmap, data[~local]))
    del blocks
    kp_max = _round_up(kp_max, 4)
    kph_max = _round_up(kph_max, 4) if kph_max else 0

    S = s_uniform if s_uniform is not None else _round_up(max(-(-rl // 128), 1), 8)
    q_all = np.zeros((D, kp_max, S), np.int32)
    r_all = np.zeros((D, kp_max, S, 128), np.int8)   # lanes 0..127
    v_all = np.zeros((D, kp_max, S, 128), np_dtype)
    qh_all = np.zeros((D, kph_max, S), np.int32)
    rh_all = np.zeros((D, kph_max, S, 128), np.int8)
    vh_all = np.zeros((D, kph_max, S, 128), np_dtype)
    for d, (kp, q, pos, lc, ld, kph, qh, posh, hmap, hd) in enumerate(layouts):
        if len(pos):
            q_all[d, :kp] = q
            r_all[d, :kp].reshape(-1)[pos] = lc & 127
            v_all[d, :kp].reshape(-1)[pos] = ld
        if kph and len(posh):
            qh_all[d, :kph] = qh
            rh_all[d, :kph].reshape(-1)[posh] = hmap & 127
            vh_all[d, :kph].reshape(-1)[posh] = hd
    del layouts

    # Exchange plan: group each partition's sorted halo set by owner.
    send: dict = {}
    recv: dict = {}
    for d in range(D):
        hc = halo_cols[d]
        owners = hc // cl
        for o in np.unique(owners):
            o = int(o)
            s = (d - o) % D
            sel = owners == o
            send.setdefault(s, {})[o] = (hc[sel] - o * cl).astype(np.int32)
            recv.setdefault(s, {})[d] = np.flatnonzero(sel).astype(np.int32)
    steps = []
    for s in sorted(send):
        hs = max(len(v) for v in send[s].values())
        si = np.zeros((D, hs), np.int32)
        rp = np.full((D, hs), H, np.int32)  # padding -> dump slot H (< H_pad)
        for o, idx in send[s].items():
            si[o, : len(idx)] = idx
        for d, posn in recv[s].items():
            rp[d, : len(posn)] = posn
        steps.append((int(s), si, rp))
    from .multihost import order_steps_dcn_first

    steps = order_steps_dcn_first(steps, D, local_devices or D)
    return DistOp(q_all, r_all, v_all, qh_all, rh_all, vh_all, tuple(steps),
                  rl, cl, H, H_pad)


def _stack(op_q, op_r, op_v, lo, hi, block_stride, nrows, ncols, device, dtype):
    """One ShuffleEll over partitions [lo, hi) of stacked (D, KP, S[, 128])
    arrays: partition j's slots source blocks offset by ``j *
    block_stride`` and fill output row groups ``j * S ...``."""
    dl = hi - lo
    kp, s = op_q.shape[1], op_q.shape[2]
    q = op_q[lo:hi] + (np.arange(dl, dtype=np.int32) * block_stride)[:, None, None]
    q = np.ascontiguousarray(q.transpose(1, 0, 2)).reshape(kp, dl * s)
    r = np.ascontiguousarray(op_r[lo:hi].transpose(1, 0, 2, 3)).reshape(kp, dl * s, 128)
    v = np.ascontiguousarray(op_v[lo:hi].transpose(1, 0, 2, 3)).reshape(kp, dl * s, 128)
    return ShuffleEll(
        torch.from_numpy(q).to(device), torch.from_numpy(r).to(device),
        torch.from_numpy(v).to(device, dtype), nrows, ncols,
    )


class PartitionedOp:
    """This rank's partitions of one :class:`DistOp` on the mesh's device,
    applied as a callable ``y = op(x)`` (``sparse.spmv`` dispatches to it).

    ``x`` holds the local partitions end to end with stride ``stride_in``
    rows, ``y`` with ``stride_out`` (each the ShuffleEll row extent of its
    level), as ``(Dl * stride,)`` or ``(Dl * stride, d)``.
    """

    def __init__(self, op: DistOp, mesh: SolverMesh, stride_in: int,
                 stride_out: int, dtype):
        D = mesh.n_partitions
        lo, hi = mesh.local_range
        dl = hi - lo
        S = op.q.shape[2]
        if S * 128 != stride_out or stride_in % 128:
            raise ValueError("partition strides disagree with the layout")
        self.halo, self.halo_pad = op.halo, op.halo_pad
        self.kp, self.kph = op.q.shape[1], op.qh.shape[1]
        self.shifts = [s for s, _, _ in op.steps]
        self.halo_nnz = 0
        dev = mesh.device
        self.A = _stack(op.q, op.r, op.v, lo, hi, stride_in // 128,
                        dl * stride_out, dl * stride_in, dev, dtype)
        self.Ah = None
        self.local = None    # (src, dst): one gather/scatter for same-rank transfers
        self.sends: list = []   # (peer rank, tag)
        self.recvs: list = []   # (peer rank, tag, rows)
        if not (op.halo_pad and self.kph):
            return
        H, Hp = op.halo, op.halo_pad
        self.Ah = _stack(op.qh, op.rh, op.vh, lo, hi, Hp // 128,
                         dl * stride_out, dl * Hp, dev, dtype)
        self.halo_nnz = int(np.count_nonzero(op.vh[lo:hi]))
        src_l, dst_l, send_idx, recv_pos, recv_dst = [], [], [], [], []
        recv_off = 0     # receive-buffer rows taken so far
        for t, (s, si, rp) in enumerate(op.steps):
            hs = si.shape[1]
            for g in range(lo, hi):          # senders, ascending
                dst = (g + s) % D
                if mesh.rank_of(dst) == mesh.rank:
                    keep = rp[dst] != H      # padding goes nowhere locally
                    src_l.append((g - lo) * stride_in + si[g][keep])
                    dst_l.append((dst - lo) * Hp + rp[dst][keep])
                else:
                    send_idx.append((g - lo) * stride_in + si[g])
                    self.sends.append((mesh.rank_of(dst), t * D + g))
            for d in range(lo, hi):          # receivers, ascending
                src = (d - s) % D
                if mesh.rank_of(src) != mesh.rank:
                    keep = rp[d] != H
                    recv_pos.append(recv_off + np.flatnonzero(keep))
                    recv_dst.append((d - lo) * Hp + rp[d][keep])
                    self.recvs.append((mesh.rank_of(src), t * D + src, hs))
                    recv_off += hs

        def idx(parts):
            return torch.from_numpy(
                np.concatenate(parts).astype(np.int64)).to(dev)

        if src_l:
            self.local = (idx(src_l), idx(dst_l))
        # An apply's remote sends come from one gather; all its receives
        # land in one buffer, whose real rows are scattered once after the
        # wait (padding rows are dropped, as on the local path).
        self.send_sizes = [len(a) for a in send_idx]
        self.send_idx = idx(send_idx) if send_idx else None
        self.recv_sel = (idx(recv_pos), idx(recv_dst)) if self.recvs else None

    def _post(self, x):
        """Post this rank's point-to-point transfers; returns (work, buffer)."""
        if not self.sends and not self.recvs:
            return None, None
        tail = tuple(x.shape[1:])
        ops = []
        if self.sends:
            sendbuf = x.index_select(0, self.send_idx)
            for (peer, tag), part in zip(
                    self.sends, torch.split(sendbuf, self.send_sizes)):
                ops.append(dist.P2POp(dist.isend, part, peer, tag=tag))
        n_recv = sum(hs for _, _, hs in self.recvs)
        recvbuf = x.new_empty((n_recv,) + tail)
        off = 0
        for peer, tag, hs in self.recvs:
            ops.append(dist.P2POp(dist.irecv, recvbuf[off:off + hs], peer, tag=tag))
            off += hs
        return dist.batch_isend_irecv(ops), recvbuf

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.Ah is None:
            return spmv(self.A, x)
        # Zeroed every apply: the dump slot H and the tail past it are
        # never written, and the halo part's padding lanes read them with
        # zero weights.
        halo = x.new_zeros((self.Ah.ncols,) + tuple(x.shape[1:]))
        work, recvbuf = self._post(x)
        if self.local is not None:
            src, dst = self.local
            halo.index_copy_(0, dst, x.index_select(0, src))
        y = spmv(self.A, x)                   # interior: needs no halo value
        if work is not None:
            for w in work:
                w.wait()
            if self.recv_sel is not None:
                sel, dst = self.recv_sel
                halo.index_copy_(0, dst, recvbuf.index_select(0, sel))
        return y + spmv(self.Ah, halo)

    def info(self) -> dict:
        """Halo size, shifts, interior KP and halo KPH of this operator,
        and the halo part's real entries against its slot lanes."""
        lanes = self.Ah.v.numel() if self.Ah is not None else 0
        return {"halo": self.halo, "halo_pad": self.halo_pad,
                "shifts": self.shifts, "kp": self.kp, "kph": self.kph,
                "halo_nnz": self.halo_nnz, "halo_lanes": lanes}


class HaloContext:
    """Row-partitioned view of a ``MultigridSolveContext`` over a
    :class:`SolverMesh`.

    Builds (once, on the host) this rank's partitioned operators and
    exchange plans for every level of the Galerkin chain, both transfers,
    the mass matrix and the replicated coarse inverse; :meth:`solve` then
    iterates cycles on the mesh's device.
    """

    def __init__(self, ctx, mesh: SolverMesh):
        t0 = time.perf_counter()
        self.ctx, self.mesh = ctx, mesh
        self.cfg = ctx.cfg
        self.dtype = ctx.dtype
        D = mesh.n_partitions
        self.ndev = D
        chain = ctx.chain_csr
        sizes = [A.shape[0] for A in chain]
        self.n = sizes[0]
        self.nloc = [partition_rows(n, D)[0] for n in sizes]
        self.stride = [partition_rows(n, D)[1] for n in sizes]
        ld = mesh.partitions_per_node if mesh.distributed else 0

        def part_op(A, k_rows, k_cols):
            op = _build_dist_op(A, D, self.nloc[k_rows], self.nloc[k_cols],
                                self.dtype, ld)
            return PartitionedOp(op, mesh, self.stride[k_cols],
                                 self.stride[k_rows], self.dtype)

        levels = []
        for k in range(self.cfg.num_levels):
            A = part_op(chain[k], k, k)
            U = part_op(ctx.U_csr[k], k, k + 1)
            UT = part_op(ctx.U_csr[k].T.tocsr(), k + 1, k)
            # lam in f64, as the reference's halo path passes it
            levels.append(LevelOps(
                A, self._local_vec(ctx._host_diag_inv[k], k),
                float(ctx.host_lam[k]), ShuffleTransfer(U, UT),
            ))
        self.levels = tuple(levels)
        self.M = part_op(ctx.mass_csr, 0, 0)
        minv = 1.0 / np.maximum(np.asarray(ctx.mass_csr.diagonal()), 1e-30)
        self._minv = self._local_vec(minv, 0)

        # Replicated coarse inverse and operator, identity-padded to the
        # partitioned size: padded rows of a zero-padded rc stay exactly
        # zero through the apply and the refinement.
        Ainv, Ad = ctx._host_coarse_inv
        self.nc = Ainv.shape[0]
        nc_pad = D * self.nloc[-1]

        def pad_identity(m):
            mp = np.eye(nc_pad, dtype=np.float64)
            mp[: self.nc, : self.nc] = m
            return torch.from_numpy(mp).to(mesh.device, self.dtype)

        self._coarse_op = (pad_identity(Ainv), pad_identity(Ad))
        self.timing = {"partition_build_s": time.perf_counter() - t0}

    # ---- layout helpers --------------------------------------------------

    def _local_vec(self, a: np.ndarray, k: int) -> torch.Tensor:
        """Level-k host array ``(n_k,)`` or ``(n_k, d)`` -> this rank's
        local vector on the device, in the compute dtype."""
        from .multihost import host_to_global

        a = np.asarray(a, dtype=np.float64)
        D, nl, P = self.ndev, self.nloc[k], self.stride[k]
        tail = a.shape[1:]
        full = np.zeros((D * nl,) + tail)
        full[: a.shape[0]] = a
        stacked = np.zeros((D, P) + tail)
        stacked[:, :nl] = full.reshape((D, nl) + tail)
        loc = host_to_global(self.mesh, stacked, self.dtype)
        return loc.reshape((-1,) + tail)

    def _all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Concatenate every rank's local vector (rank order)."""
        if not self.mesh.distributed:
            return t
        parts = [torch.empty_like(t) for _ in range(self.mesh.world_size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def _coarse(self, rc: torch.Tensor) -> torch.Tensor:
        """Coarsest-level solve on the all-gathered right-hand side (the
        single-device ``_coarse_solve`` on the padded inverse), then this
        rank's slice."""
        D, nl, P = self.ndev, self.nloc[-1], self.stride[-1]
        tail = tuple(rc.shape[1:])
        full = self._all_gather(rc).reshape((D, P) + tail)[:, :nl]
        Ainv, Ad = self._coarse_op
        rc2 = full.reshape(D * nl, -1).to(Ainv.dtype)
        with _full_fp32_matmul():
            e = Ainv @ rc2
            e = e + Ainv @ (rc2 - Ad @ e)
        if self.cfg.coarse_null_project:
            # padded rows hold zeros, so the sums are over the real rows
            e = e - e.sum(dim=0, keepdim=True) / self.nc
        lo, hi = self.mesh.local_range
        e = e.to(rc.dtype).reshape((D, nl) + tail)[lo:hi]
        out = rc.new_zeros((hi - lo, P) + tail)
        out[:, :nl] = e
        return out.reshape(rc.shape)

    def _residual_num_sq(self, b, x, criteria: int) -> torch.Tensor:
        """Per-column squared residual numerators, summed over the mesh."""
        r = spmv(self.levels[0].A, x) - b
        r2 = r[:, None] if r.ndim == 1 else r
        if criteria in (0, 3):
            loc = (r2 * r2).sum(0)
        elif criteria == 1:
            loc = (r2 * (self._minv[:, None] * r2)).sum(0)
        elif criteria == 2:
            loc = (r2 * spmv(self.M, r2)).sum(0)
        else:
            raise ValueError(f"unknown stopping criteria {criteria}")
        if self.mesh.distributed:
            dist.all_reduce(loc)
        return loc

    # ---- host API ----------------------------------------------------------

    def solve(self, rhs: np.ndarray, *, tol: float = 1e-4, criteria: int = 2,
              max_iter: int = 100):
        """Deflate (host, f64), iterate cycles to ``tol``, un-deflate.

        ``rhs`` is the full ``(n,)`` or ``(n, d)`` right-hand side on every
        rank.  The host loop reads the all-reduced residual after every
        cycle (no lookahead), so every rank stops after the same cycle;
        the criterion is the max over columns.  Returns ``(x, iters,
        res)`` with the full solution on every rank.
        """
        ctx = self.ctx
        rhs = np.asarray(rhs, dtype=np.float64)
        squeeze = rhs.ndim == 1
        rhs2 = rhs[:, None] if squeeze else rhs
        d = rhs2.shape[1]
        alpha = deflation_alpha(ctx.row_sums, rhs2, ctx.diag_scale)   # (d,)
        b_eff = rhs2 - alpha[None, :] * ctx.row_sums[:, None]

        # Denominators from the ORIGINAL rhs, on the host in f64.
        M = ctx.mass_csr
        if criteria == 0:
            den = np.linalg.norm(rhs2, axis=0)
        elif criteria == 1:
            minv = 1.0 / np.maximum(M.diagonal(), 1e-300)
            den = np.sqrt((rhs2 * (minv[:, None] * rhs2)).sum(axis=0))
        elif criteria == 2:
            den = np.sqrt((rhs2 * (M @ rhs2)).sum(axis=0))
        elif criteria == 3:
            den = np.ones(d)
        else:
            raise ValueError(f"unknown stopping criteria {criteria}")
        den = torch.from_numpy(np.maximum(den, 1e-30)).to(self.mesh.device, self.dtype)

        b = self._local_vec(b_eff[:, 0] if squeeze else b_eff, 0)
        x = torch.zeros_like(b)
        t0 = time.perf_counter()
        iters, res = 0, float("inf")
        while res > tol and iters < max_iter:
            x = cycle_step(self.cfg, self.levels, self._coarse, b, x)
            num_sq = self._residual_num_sq(b, x, criteria)
            res = float(torch.max(torch.sqrt(num_sq) / den))
            iters += 1
        self.timing["cycles_ms"] = (time.perf_counter() - t0) * 1000
        D, nl, P = self.ndev, self.nloc[0], self.stride[0]
        full = self._all_gather(x).double().cpu().numpy()
        y = full.reshape((D, P) + full.shape[1:])[:, :nl]
        y = y.reshape((D * nl,) + full.shape[1:])[: self.n]
        y = (y + alpha[0]) if squeeze else (y + alpha[None, :])
        return y, iters, res

    def plan_info(self) -> List[dict]:
        """Per level: nloc, and the A / U / U^T halo sizes, shifts, KP, KPH."""
        return [
            {"nloc": self.nloc[k], "A": lvl.A.info(), "U": lvl.U.U.info(),
             "UT": lvl.U.UT.info()}
            for k, lvl in enumerate(self.levels)
        ]
