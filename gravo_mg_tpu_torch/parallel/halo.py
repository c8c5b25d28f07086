"""Distributed multigrid with a static halo exchange, on ``torch.distributed``.

Counterpart of ``gravo_mg_tpu/parallel/halo.py``.  The rows of every level
operator, both transfers and the mass matrix are block-partitioned over
``D`` partitions (:class:`SolverMesh`); each rank holds
``D / world_size`` consecutive ones.

* Host partitioner (once per context, :func:`_halo_plan`): for each
  partition the off-partition columns it touches form its sorted **halo
  set**, and the exchange plan groups each halo set by owner into ring
  shifts.  Given the same csr it gives the reference's plan bit for bit
  (:func:`_build_dist_op` adds the reference's shuffle-ELL arrays, for the
  parity tests).
* Device apply (:class:`PartitionedOp`): each entry of a partition's rows
  is **interior** (its column inside the partition) or **halo** (its
  column in the halo buffer).  A rank's interior parts are stacked into
  one block-diagonal operator in the port's own layouts (SlicedDiag or
  SlicedEll), its halo parts into one compact SlicedEll over the boundary
  rows; each apply is two launches whatever the number of partitions:
  post the exchange, interior SpMV (reads only local blocks), wait, halo
  SpMV added into the interior's output (``ops/halo_spmv.py``).  The
  cycle's residual, prolongation add and Chebyshev step are the same two
  launches with the epilogue inside them (:meth:`PartitionedOp.residual`,
  ``add``, ``cheb``), where the JAX program has XLA fuse the sum and the
  elementwise work around its two Pallas calls: the interior launch
  applies it on the rows without a halo part (a row mask) and the halo
  launch on the boundary rows, after their add.
* Exchange: for ring shift ``s`` partition ``i`` gathers
  ``x_loc[send_idx[i]]`` and sends it to ``(i + s) % D``, which scatters it
  to ``halo[recv_pos]`` (``jax.lax.ppermute`` semantics; padding, which
  names the dump slot ``H``, is dropped).  Between partitions of one rank
  the transfer is a device-local gather/scatter; between ranks it is one
  ``dist.batch_isend_irecv`` of every rank's point-to-point transfers.
* The cycle is the single-device one (``solver/multigrid.py``) over the
  partitioned operators; the coarsest level all-gathers its right-hand
  side and applies the replicated, identity-padded coarse inverse; the
  residual check all-reduces per-column sums.
* The loop (:meth:`HaloContext.solve`) is the JAX package's
  ``shard_map``-wrapped ``while_loop`` by default: the single-device
  :class:`~gravo_mg_tpu_torch.solver.multigrid.FusedLoop` over the
  partitioned levels, the coarse solve and the all-reduced residual, so
  on the card one halo cycle, its NCCL collectives and point-to-point
  transfers included, is captured once as a CUDA graph and run under a
  conditional WHILE node: one launch and one host wait per solve.  Every
  rank's node reads the same all-reduced stop flag, so every rank runs
  the same number of cycles and no collective is left unmatched.
  ``mode="traced"`` steps the cycles from the host.

The local vector of a level is this rank's partitions laid end to end,
each padded from ``nloc`` rows to ``stride`` rows (a multiple of 1024), so
operator outputs need no compaction; padded rows stay exactly zero.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from ..ops.epilogue import row_mask_from_rows
from ..ops.halo_spmv import (
    halo_spmv,
    halo_spmv_add,
    halo_spmv_cheb,
    halo_spmv_residual,
)
from ..solver.multigrid import (
    FusedLoop,
    LevelOps,
    _FUSED_TIMING,
    _full_fp32_matmul,
    cycle_step,
    deflation_alpha,
    loop_timing,
    release_loops,
)
from ..sparse import (
    ShuffleTransfer,
    _shuffle_layout,
    cheb_step,
    numpy_dtype,
    sliced_bytes,
    sliced_from_scipy,
    sliced_layout_from_scipy,
    spmv,
    spmv_add,
    spmv_residual,
)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def partition_rows(n: int, D: int) -> Tuple[int, int]:
    """Rows per partition of an ``n``-row level over ``D`` partitions
    (128-aligned, as the reference's) and its local stride (a multiple of
    1024, so no 32-row slice of a stacked layout straddles two
    partitions)."""
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
class HaloPlan:
    """The exchange plan of one row-partitioned operator (host numpy).

    ``halo_cols[d]`` is partition ``d``'s sorted halo set (the global
    columns outside the partition that its rows touch).  ``steps`` holds
    one ``(shift, send_idx (D, Hs), recv_pos (D, Hs))`` per ring shift with
    traffic: partition ``d`` gathers ``x_local[send_idx[d]]`` for ``(d +
    shift) % D``, which scatters it to ``halo[recv_pos]``; padding entries
    name the dump slot ``halo``.
    """

    halo_cols: List[np.ndarray]
    steps: Tuple
    rows_local: int
    cols_local: int
    halo: int              # real halo entries (max over partitions)
    halo_pad: int          # halo buffer length, multiple of 128, > halo


@dataclasses.dataclass
class DistOp:
    """One row-partitioned operator as the reference's host arrays stacked
    over the ``D`` partitions (the reference's DistOp, before it is put on
    devices): the exchange plan and the shuffle-ELL slots of each part.

    ``q/r/v`` are the interior slots (source blocks inside the partition),
    ``qh/rh/vh`` the halo slots (sourcing the halo buffer); ``steps`` as in
    :class:`HaloPlan`.
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
    halo: int
    halo_pad: int


def _canonical(A_csr):
    """A csr matrix with sorted indices and no duplicates (a copy only
    where the input is not)."""
    A = A_csr.tocsr()
    if not A.has_canonical_format:
        A = A.copy()
        A.sum_duplicates()
    return A


def _partition_entries(A, d: int, rl: int, cl: int):
    """Partition ``d``'s rows of canonical csr ``A``: (row within the
    partition, global column, value, interior mask) per entry, in csr
    order; an entry is interior when its column lies in the partition's
    own column block."""
    nr = A.shape[0]
    r0, r1 = min(d * rl, nr), min((d + 1) * rl, nr)
    ip = A.indptr
    rows = np.repeat(np.arange(r1 - r0, dtype=np.int64), np.diff(ip[r0:r1 + 1]))
    cols = A.indices[ip[r0]:ip[r1]].astype(np.int64)
    local = (cols >= d * cl) & (cols < (d + 1) * cl)
    return rows, cols, A.data[ip[r0]:ip[r1]], local


def _halo_plan(A_csr, D: int, rl: int, cl: int, local_devices: int = 0) -> HaloPlan:
    """The halo sets and exchange plan of a global csr operator split into
    ``D`` row blocks of ``rl`` rows (columns in blocks of ``cl``); given
    the same csr, the reference's plan bit for bit.

    ``local_devices`` (partitions per node) orders the exchange steps
    inter-node first; 0 means one node (order by |shift|).
    """
    if cl % 128:
        raise ValueError("the per-partition column block must be 128-aligned")
    A = _canonical(A_csr)
    halo_cols: List[np.ndarray] = []
    for d in range(D):
        _, cols, _, local = _partition_entries(A, d, rl, cl)
        halo_cols.append(np.unique(cols[~local]))
    H = max((len(h) for h in halo_cols), default=0)
    # 128-aligned, with at least one spare slot for the exchange's padding.
    H_pad = _round_up(H + 1, 128) if H else 0

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
    return HaloPlan(halo_cols, tuple(steps), rl, cl, H, H_pad)


def _build_dist_op(A_csr, D: int, rl: int, cl: int, dtype,
                   local_devices: int = 0) -> DistOp:
    """The reference's DistOp of a global csr operator: :func:`_halo_plan`
    plus each partition's interior and halo parts in shuffle-ELL form
    (host numpy).  This is the JAX package's TPU layout; no solve builds
    it (:class:`PartitionedOp` lays the parts out from the csr itself).

    Values are written straight in ``dtype`` (a numpy or torch dtype),
    which rounds each entry exactly as the reference's f64-then-cast does.
    """
    if isinstance(dtype, torch.dtype):
        dtype = numpy_dtype(dtype)
    np_dtype = np.dtype(dtype)
    plan = _halo_plan(A_csr, D, rl, cl, local_devices)
    A = _canonical(A_csr)
    H, H_pad = plan.halo, plan.halo_pad

    layouts = []
    kp_max, kph_max, s_uniform = 1, 0, None
    for d in range(D):
        rows, cols, data, local = _partition_entries(A, d, rl, cl)
        kp, s, q, pos = _shuffle_layout(rows[local], cols[local] - d * cl, rl, cl)
        if s_uniform is None:
            s_uniform = s
        if s != s_uniform:
            raise AssertionError("row-group count differs between partitions")
        kp_max = max(kp_max, kp)
        if H:
            hmap = np.searchsorted(plan.halo_cols[d], cols[~local])
            kph, _, qh, posh = _shuffle_layout(rows[~local], hmap, rl, H_pad)
            kph_max = max(kph_max, kph if len(hmap) else 0)
        else:
            kph, qh, posh, hmap = 0, None, None, None
        layouts.append((kp, q, pos, cols[local] - d * cl, data[local],
                        kph, qh, posh, hmap, data[~local]))
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
    return DistOp(q_all, r_all, v_all, qh_all, rh_all, vh_all, plan.steps,
                  rl, cl, H, H_pad)


def _csr(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray, shape):
    """A csr matrix of entries already in csr order (rows ascending,
    columns ascending within a row)."""
    indptr = np.zeros(shape[0] + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=shape[0]), out=indptr[1:])
    return sp.csr_matrix((vals, cols, indptr), shape=shape)


class PartitionedOp:
    """This rank's partitions of a row-partitioned operator on the mesh's
    device, applied as a callable ``y = op(x)`` (``sparse.spmv``
    dispatches to it).

    ``x`` holds the local partitions end to end with stride ``stride_in``
    rows, ``y`` with ``stride_out`` (multiples of 1024, so no 32-row slice
    straddles two partitions), as ``(Dl * stride,)`` or ``(Dl * stride,
    d)``.  Built from the global csr ``A_csr`` and its :class:`HaloPlan`:

    * ``A``: the interior parts as one block-diagonal operator (partition
      ``j``'s rows at ``j * stride_out``, its columns at ``j *
      stride_in``), laid out by :func:`sparse.sliced_rule` at
      ``diag_min_groups`` (the planner's rule for a level operator), or as
      SlicedEll where that is None (the single-device choice for transfers
      and the mass matrix);
    * ``Ah``: the halo parts as one SlicedEll over the rows that have a
      halo entry only, its columns into the halo buffer (partition ``j``'s
      halo set at ``j * halo_pad``), and ``out_row`` (int32) their rows in
      ``y``, ``row_mask`` the same rows as the interior launch's row mask
      (``ops/epilogue.py``); None where no partition has a halo.

    :meth:`residual`, :meth:`add` and :meth:`cheb` are the cycle's
    operations on ``self(x)`` in the same two launches (``sparse.spmv_residual``,
    ``spmv_add`` and ``cheb_step`` send a PartitionedOp here), bitwise
    equal to ``epilogue_plain`` after ``self(x)``.
    """

    def __init__(self, A_csr, plan: HaloPlan, mesh: SolverMesh, stride_in: int,
                 stride_out: int, dtype, diag_min_groups: Optional[int] = None):
        D = mesh.n_partitions
        lo, hi = mesh.local_range
        dl = hi - lo
        rl, cl = plan.rows_local, plan.cols_local
        if (stride_in % 1024 or stride_out % 1024 or stride_in < cl
                or stride_out < rl):
            raise ValueError("partition strides disagree with the plan")
        self.halo, self.halo_pad = plan.halo, plan.halo_pad
        self.shifts = [s for s, _, _ in plan.steps]
        H, Hp = plan.halo, plan.halo_pad
        dev = mesh.device
        A = _canonical(A_csr)
        inner, outer = [], []
        for j, g in enumerate(range(lo, hi)):
            rows, cols, data, local = _partition_entries(A, g, rl, cl)
            inner.append((rows[local] + j * stride_out,
                          cols[local] - g * cl + j * stride_in, data[local]))
            h = ~local
            outer.append((rows[h] + j * stride_out,
                          np.searchsorted(plan.halo_cols[g], cols[h]) + j * Hp,
                          data[h]))
        interior = _csr(*map(np.concatenate, zip(*inner)),
                        (dl * stride_out, dl * stride_in))
        if diag_min_groups is None:
            self.A = sliced_from_scipy(interior, dtype)
        else:
            self.A = sliced_layout_from_scipy(interior, dtype,
                                              min_groups=diag_min_groups)
        self.A = self.A.to(dev)
        self.Ah = None
        self.local = None    # (src, dst): one gather/scatter for same-rank transfers
        self.sends: list = []   # (peer rank, tag)
        self.recvs: list = []   # (peer rank, tag, rows)
        self._buffers: dict = {}   # (dtype, trailing shape) -> halo buffer
        if not Hp:
            return
        out, hcol, hval = map(np.concatenate, zip(*outer))
        brow, row = np.unique(out, return_inverse=True)
        self.Ah = sliced_from_scipy(_csr(row.reshape(-1), hcol, hval,
                                         (brow.size, dl * Hp)), dtype).to(dev)
        self.out_row = torch.from_numpy(brow.astype(np.int32)).to(dev)
        self.row_mask = row_mask_from_rows(brow, self.A.nrows).to(dev)
        self.halo_real = sum(len(plan.halo_cols[g]) for g in range(lo, hi))
        src_l, dst_l, send_idx, recv_pos, recv_dst = [], [], [], [], []
        recv_off = 0     # receive-buffer rows taken so far
        for t, (s, si, rp) in enumerate(plan.steps):
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
        """Post this rank's point-to-point transfers; returns (work, buffer).

        Legal inside a CUDA graph capture (the buffers come from the
        graph's pool, ``wait`` only makes the stream wait) once the NCCL
        communicators exist: the first, eager step of a fused solve
        (``device_loop.StepGraph``) creates them, the point-to-point ones
        that NCCL makes lazily included, before anything is captured."""
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

    def _halo_buffer(self, x):
        """The halo buffer for x's dtype and trailing shape, kept across
        applies.  It is zeroed once: every apply rewrites each real halo
        position, and the rest (each partition's tail, the dump slot) is
        never written and is read only by padding lanes of weight 0."""
        key = (x.dtype,) + tuple(x.shape[1:])
        buf = self._buffers.get(key)
        if buf is None:
            buf = x.new_zeros((self.Ah.ncols,) + tuple(x.shape[1:]))
            self._buffers[key] = buf
        return buf

    def _exchange(self, x):
        """Post the exchange and fill the device-local halo positions;
        returns ``finish()``, which waits for the transfers, scatters the
        received rows and returns the halo buffer.  The interior launch
        goes between the two: it reads no halo value."""
        halo = self._halo_buffer(x)
        work, recvbuf = self._post(x)
        if self.local is not None:
            src, dst = self.local
            halo.index_copy_(0, dst, x.index_select(0, src))

        def finish():
            if work is not None:
                for w in work:
                    w.wait()
                if self.recv_sel is not None:
                    sel, dst = self.recv_sel
                    halo.index_copy_(0, dst, recvbuf.index_select(0, sel))
            return halo

        return finish

    def _halo_args(self, halo):
        Ah = self.Ah
        return Ah.slice_ptr, Ah.col, Ah.val, self.out_row, halo

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.Ah is None:
            return spmv(self.A, x)
        finish = self._exchange(x)
        y = spmv(self.A, x)
        return halo_spmv(*self._halo_args(finish()), y, self.Ah.tpr)

    def residual(self, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``b - self(x)``: the residual on the interior's rows without a
        halo part, then on the boundary rows after their halo add."""
        if self.Ah is None:
            return spmv_residual(self.A, x, b)
        finish = self._exchange(x)
        y = spmv_residual(self.A, x, b, self.row_mask)
        return halo_spmv_residual(*self._halo_args(finish()), y, b, self.Ah.tpr)

    def add(self, x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        """``z + self(x)`` (the prolongation's ``x + U e``, e as x here)."""
        if self.Ah is None:
            return spmv_add(self.A, x, z)
        finish = self._exchange(x)
        y = spmv_add(self.A, x, z, self.row_mask)
        return halo_spmv_add(*self._halo_args(finish()), y, z, self.Ah.tpr)

    def cheb(self, dinv, b, x, d, c1, c2: float, keep_d: bool = True):
        """One smoother step on ``self`` (``sparse.cheb_step``): returns
        ``(x + d_new, d_new)``, d_new None where ``keep_d`` is false."""
        if self.Ah is None:
            return cheb_step(self.A, dinv, b, x, d, c1, c2, keep_d)
        finish = self._exchange(x)
        x_out, d_new = cheb_step(self.A, dinv, b, x, d, c1, c2, keep_d, self.row_mask)
        x_out, _ = halo_spmv_cheb(*self._halo_args(finish()), x_out, x, b, dinv,
                                  d_new if keep_d else d, c1, c2, self.Ah.tpr)
        return x_out, d_new

    def info(self) -> dict:
        """Halo size and shifts; the interior's layout, stored entries and
        bytes per apply at d = 1 (``info()["bytes"]`` of its layout); the
        halo part's rows, nonzeros, stored entries and bytes per apply at
        d = 1 (a column and a value per stored entry, the slice offsets,
        ``out_row``, y read and written at its rows, and this rank's real
        halo positions once)."""
        inner = self.A.info()
        out = {"halo": self.halo, "halo_pad": self.halo_pad, "shifts": self.shifts,
               "interior": type(self.A).__name__,
               "interior_entries": inner["entries"], "interior_bytes": inner["bytes"],
               "halo_rows": 0, "halo_nnz": 0, "halo_entries": 0, "halo_bytes": 0}
        if self.Ah is not None:
            item = self.Ah.val.element_size()
            rows = self.Ah.nrows
            out.update(halo_rows=rows, halo_nnz=self.Ah.nnz,
                       halo_entries=int(self.Ah.col.numel()),
                       halo_bytes=sliced_bytes(self.Ah.slice_ptr.cpu().numpy(), item)
                       + rows * (4 + 2 * item) + self.halo_real * item)
        return out


class HaloContext:
    """Row-partitioned view of a ``MultigridSolveContext`` over a
    :class:`SolverMesh`.

    Builds (once, on the host) this rank's partitioned operators and
    exchange plans for every level of the Galerkin chain, both transfers,
    the mass matrix and the replicated coarse inverse; :meth:`solve` then
    iterates cycles on the mesh's device.

    ``mode="fused"`` keeps one loop per ``(columns, criteria, max_iter)``,
    as the JAX package keys its compiled loop, and one graph pool for all
    of them (:meth:`release_graphs` drops both).
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

        def part_op(A, k_rows, k_cols, diag_min_groups=None):
            plan = _halo_plan(A, D, self.nloc[k_rows], self.nloc[k_cols], ld)
            return PartitionedOp(A, plan, mesh, self.stride[k_cols],
                                 self.stride[k_rows], self.dtype, diag_min_groups)

        levels = []
        for k in range(self.cfg.num_levels):
            # level interiors by the planner's rule; transfers and M SlicedEll
            A = part_op(chain[k], k, k, ctx.diag_min_groups)
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
        self._fused: dict = {}
        self._graph_pool = None
        self.dispatched = 0    # cycles the last solve ran
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
        """Per-column squared residual numerators, summed over the mesh.
        The residual is ``b - A x`` (two launches); the JAX package forms
        ``A x - b``, its exact negation, and every criterion is even in r."""
        r = spmv_residual(self.levels[0].A, x, b)
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

    def release_graphs(self) -> None:
        """Drop the fused solves' loops and graphs, and so their memory
        pool (as ``MultigridSolveContext.release_graphs``)."""
        release_loops(self._fused, self.mesh.device)
        self._graph_pool = None

    def _fused_loop(self, cols, criteria: int, max_iter: int) -> FusedLoop:
        key = (cols, criteria, max_iter)
        loop = self._fused.get(key)
        if loop is None:
            if self._graph_pool is None and self.mesh.device.type == "cuda":
                self._graph_pool = torch.cuda.graph_pool_handle()
            loop = self._fused[key] = FusedLoop(
                self.cfg, self.levels, self._coarse,
                lambda b, x: torch.sqrt(self._residual_num_sq(b, x, criteria)),
                max_iter, self._graph_pool)
        return loop

    def solve(self, rhs: np.ndarray, *, tol: float = 1e-4, criteria: int = 2,
              max_iter: int = 100, mode: str = "fused"):
        """Deflate (host, f64), iterate cycles to ``tol``, un-deflate.

        ``rhs`` is the full ``(n,)`` or ``(n, d)`` right-hand side on every
        rank; the criterion is the max over columns, all-reduced, so every
        rank stops after the same cycle.  ``mode="fused"`` is the JAX
        package's device loop (:class:`FusedLoop`): on the card one halo
        cycle, captured once per ``(columns, criteria, max_iter)``, runs
        under a conditional WHILE node, one graph launch and one host wait
        per warm solve; a capture, build or launch that fails raises.
        ``mode="traced"`` is a host loop that reads the residual after
        every cycle (no lookahead), with honest per-cycle times.  Both
        return the first iterate that meets tol: ``(x, iters, res)`` with
        the full solution on every rank.  ``timing`` holds ``cycles_ms``
        and, after a fused solve, ``host_reads``, ``graph_launches``,
        ``graph_captures``, ``graph_capture_ms``, ``graph_build_ms`` and
        ``graph_pool_mib``.
        """
        if mode not in ("traced", "fused"):
            raise ValueError(f"unknown solve mode {mode!r}")
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
        for key in _FUSED_TIMING:
            self.timing.pop(key, None)
        t0 = time.perf_counter()
        if mode == "fused":
            loop = self._fused_loop(None if squeeze else d, criteria, max_iter)
            x, iters, res, _, reads, launches = loop.run(b, x, den, tol)
            self.dispatched = iters
            self.timing.update(loop_timing(loop, reads, launches))
        else:
            iters, res = 0, float("inf")
            while res > tol and iters < max_iter:
                x = cycle_step(self.cfg, self.levels, self._coarse, b, x)
                num_sq = self._residual_num_sq(b, x, criteria)
                res = float(torch.max(torch.sqrt(num_sq) / den))
                iters += 1
            self.dispatched = iters
        self.timing["cycles_ms"] = (time.perf_counter() - t0) * 1000
        D, nl, P = self.ndev, self.nloc[0], self.stride[0]
        full = self._all_gather(x).double().cpu().numpy()
        y = full.reshape((D, P) + full.shape[1:])[:, :nl]
        y = y.reshape((D * nl,) + full.shape[1:])[: self.n]
        y = (y + alpha[0]) if squeeze else (y + alpha[None, :])
        return y, iters, res

    def plan_info(self) -> List[dict]:
        """Per level: nloc, and the A / U / U^T :meth:`PartitionedOp.info`
        (halo sizes, shifts, layouts, stored entries, bytes per apply)."""
        return [
            {"nloc": self.nloc[k], "A": lvl.A.info(), "U": lvl.U.U.info(),
             "UT": lvl.U.UT.info()}
            for k, lvl in enumerate(self.levels)
        ]
