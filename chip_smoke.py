#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines, with the kernel launch counts of that
phase, counted from 0; any failure exits non-zero before the last line):

1. build: the native host library (g++) and the CUDA kernels (nvcc,
   sm_90a; five sources: five SpMV kernels, and the loop-control kernel
   and graph calls of the fused loop's WHILE graph) from the sources in
   this checkout, all compilers at once;
2. kernels: each kernel against its plain PyTorch version on the card at
   real operator shapes, d = 1 and 3, f32 (plus one f64 check each), with
   times and bounds: every SlicedEll operator of the 1M Poisson context
   (A1-A3, U0-U3, U0^T-U3^T, M), CG's operator as SlicedEll and the finest
   U0^T of the 262k SIG21 hierarchy through sliced_spmv, each beside the
   same operator in the JAX package's ShuffleEll layout through
   shuffle_spmv (the route it replaced), both plain versions and a
   cuSPARSE CSR product (``library_ms``, a yardstick the port never
   calls), timed in turns (device time from torch.profiler, beside CUDA
   events), with the bound, every threads-per-row variant of sliced_spmv,
   and the sums over one 1M V-cycle; the SlicedDiag operators (A0, CG's
   operator, MinQuad's finest level) through sliced_diag_spmv, beside
   diag_spmv on A0's DiagEll (the route they replaced, built here),
   cuSPARSE and the plain version, with bytes per apply, the layout's
   bound and the format-neutral one; the epilogues of both kernels (a
   Chebyshev step, first and later, and the residual on A0 and A1, the
   prolongation's add on U0; d = 1 f32 and d = 3 f64): each launch beside
   the kernel's plain-mode SpMV followed by the torch ops (held bitwise
   equal to it), the bare SpMV, the plain version and, for the residual
   and the add, cuSPARSE's addmv/addmm on the same CSR, with bytes and
   bound (SlicedDiag: its layout's, with the format-neutral beside); the halo
   path's parts (1M over 4 partitions): the stacked A0 interior
   (sliced_diag_spmv), the stacked U0^T interior (sliced_spmv) and the
   compact halo parts of A0 and U0^T (halo_spmv), each against its plain
   version and cuSPARSE on the same CSR, with its bound; the halo path's
   operations (a Chebyshev step, first and later, and the residual on the
   partitioned A0, the add on the partitioned U0; d = 1 f32 and d = 3
   f64): each the interior launch under its row mask and halo_spmv in the
   same mode, held bitwise equal to the partitioned apply followed by the
   torch ops and each launch alone to its plain-mode launch followed by
   the torch ops, timed beside the bare apply, the unmasked interior
   launch, halo_spmv in plain mode, the plain versions and cuSPARSE's
   addmv/addmm on the whole partitioned operator's CSR, with bounds; and
   the route the halo parts replaced, the old stacked A0 ShuffleEll
   through shuffle_spmv;
3. smoothing: the 10k icosphere(5, bump=0.15) smoothing solve
   (M + 1e-3 S, rhs M @ V) through MultigridSolver(device="cuda"),
   checked against a host direct solve;
4. poisson: the 1M-vertex torus Poisson solve (1e-6 M + S, rhs M @ randn,
   seed 42, tol 1e-4, criterion 2, lower_bound 1000) through the facade
   in mode="fused" (the cycle captured as a CUDA graph and run under a
   conditional WHILE node: one graph launch and one host wait per warm
   solve) beside mode="traced" (the host loop): cold and 5 warm solves
   of each in turns, the fused iterate and trace held bitwise equal to
   the traced ones, the host reads and graph launches of every fused
   solve, one capture and one WHILE graph in all, the WHILE graph's
   nodes, build ms and device ms (CUDA events around its launches), and
   one warm solve of each under torch.profiler (kernel ms per cycle run
   by kernel, device idle share); then the same fused solve with the
   plain compositions patched in (each operation as the SpMV followed by
   its torch ops), its iterate, trace and cycles held bitwise equal, the
   two WHILE graphs' kernels, nodes, device ms and warm ms in turns (the
   epilogues' no slower), the captured cycle at most 80 kernels;
   halo: the same system on phase poisson's context over 4 row partitions
   (``parallel.halo.HaloContext``) held by one NCCL rank on this card
   (one-rank process group, ``file://`` rendezvous): each part's layout,
   stored entries and bytes per apply, the halo parts' bytes per cycle;
   the solve in mode="fused" (one halo cycle, its NCCL all-gather and
   all-reduce included, captured as a CUDA graph and run under the WHILE
   node) beside mode="traced" (the host loop), cold and 5 warm solves
   each, the fused iterate held bitwise equal to the traced one and both
   against phase poisson's solution, host reads, graph launches and the
   WHILE graph's device ms as in phase poisson, one warm solve of each
   under torch.profiler; then the same fused solve with the plain
   compositions patched in, its iterate, trace, cycles and residual held
   bitwise equal, the two WHILE graphs' kernels, nodes, device ms and
   warm ms in turns, the captured halo cycle at most 230 kernels and
   halo_spmv launched in every epilogue;
   halo-multigpu: where the machine has 2 or more GPUs, the same system
   over one NCCL rank per GPU (4 ranks, or 2 with fewer than 4 GPUs;
   ``chip_smoke.py --halo-rank`` processes, ``file://`` rendezvous), fused
   beside traced on every rank, against each rank's single-device solve;
   with one GPU it prints that it did not run (``--multigpu-only`` runs
   this phase alone);
5. cg: ``solver.cg_solve`` on the same torus, lhs M + 1e-3 S, rhs
   M @ randn (seed 42), tol 1e-4, max_iter 2000 (its 32-iteration unit
   replayed from a CUDA graph);
6. minquad: MinQuadWithFixedMG on that solver (built with the 1M system,
   before phase kernels), lhs S + 1e-3 M, 5% of the vertices known,
   criterion 2, tol 1e-4, max_iter 20, traced and fused (cold and warm,
   their host reads and graph launches);
7. flow: three ConformalFlow steps on the 1M torus (tau 1e-3, tol 1e-4,
   f64: f32's residual floor on this system is above 1e-4), one solver
   context throughout, each step's system solved traced and fused (cold
   after update_lhs, then warm), device memory reserved flat over the
   steps;
8. baselines: the reference protocol's "Torus 262K" row
   (torus_mesh(724, 362, r=0.5), area-normalized, cotan S, Voronoi M,
   lhs M + 1e-3 S, rhs M @ randn, seed 0) with OURS, SIG06, ablation and
   SIG21 hierarchies, beside the reference tables' cycle counts;
9. hierarchy: the device hierarchy engines (Luby sampling, Bellman-Ford
   clustering, batched prolongation weights in torch on the card,
   ``hierarchy_engine="device"``): the 1M torus build with its stage times
   beside phase poisson's native build, dof, rounds, branch stats and the
   build's peak device memory, then the 1M Poisson solve on it (<= 6
   cycles); the 65k torus built on the card and on the CPU (samples,
   labels, coarse graphs and rounds identical, U within 1e-5 on >= 99.9%
   of rows); SIG06 and ablation at 262k on the device engines beside
   phase baselines' cycles;
10. comparisons: the port's comparison harness
   (``python -m gravo_mg_tpu_torch.experiments.comparisons``) at its
   default generated sizes (10k and 40k spheres, 16k and 65k tori) on
   the card in mode="fused": direct, SIG21, SIG06, CG and ours, then the
   ablation hierarchy, 3 repetitions each (cold and warm solves), and its
   table generator; every row must meet tol, and every multigrid solve
   must be one WHILE-graph launch, cold and warm (one host read warm).

Every solve's residual is recomputed on the host in f64.  An early line
gives the card's name and power limit (nvidia-smi); the third-to-last
line is a JSON object ``{"loop": ...}`` for the WHILE graph's
loop-control kernel (its
launches, the graph's launches and bodies in phase poisson, nodes, build
and device ms); the second-to-last line is a JSON object with one entry
per SpMV kernel (launches summed over the solve phases, per epilogue
too, and each epilogue's times); the last line
is ``{"ok": true, "device": {...}}``.
The script needs CUDA and the rest of the repository; without either it
exits non-zero.
"""

import atexit
import contextlib
import copy
import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import scipy.sparse as sp

TOL_F32 = 1e-5    # kernel vs plain, relative to max |y|
TOL_F64 = 1e-12
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
FP64_FLOPS = 34e12
TORUS_1M = (1024, 1024)
# phase kernels' epilogue cases and a Chebyshev step's coefficients
EPI_OPS = ("cheb_next", "cheb_first", "residual")
EPI_C1, EPI_C2 = 0.3717, 0.8391
TORUS_262K = (724, 362)
# experiments/out/timing/noef_smoothing_all_0.001_table.csv, "Torus 262K"
# (the reference protocol's cycle counts; printed beside ours, not a bar)
REFERENCE_CYCLES_262K = {"ours": 4, "sig06": 6, "ablation": None, "sig21": 29}


def log(msg=""):
    print(msg, flush=True)


def fail(phase, exc=None):
    log(f"FAILED phase {phase}")
    if exc is not None:
        traceback.print_exc()
    sys.exit(1)


def cuda_time_ms(fn, reps):
    import torch

    for _ in range(3):   # warm (clocks, caches)
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def time_in_turns(fns, order, reps=20):
    """Per-call ms of each function in ``fns``, taken in the turns of
    ``order`` (``reps`` calls a turn, 3 for a plain version) and averaged
    over its turns, two ways: CUDA events around the turn (``event``: the
    device timeline per call, gaps where it waits for the host included)
    and the summed durations of the kernels, copies and fills the calls
    ran (``device``), from a torch.profiler session of its own per turn.
    A call of a few us is bound by the host's launch rate, so only the
    device time says what its kernel costs.  Every timed function runs
    at least one device operation a call, so a session that recorded
    fewer than one a call lost some and is taken again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def calls(k):
        return 3 if "plain" in k else reps

    event, device = {}, {}
    for k in order:
        event.setdefault(k, []).append(cuda_time_ms(fns[k], calls(k)))
        # A session now and then records no kernels, and once three in a
        # row did: retry more often, with a pause for the profiler's
        # activity buffers.
        for attempt in range(8):
            torch.cuda.synchronize()
            time.sleep(0.1 * attempt)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls(k)):
                    fns[k]()
                torch.cuda.synchronize()
            ops = [e for e in prof.events()
                   if getattr(e.device_type, "name", "") == "CUDA"]
            busy = sum(e.time_range.end - e.time_range.start for e in ops)
            if len(ops) >= calls(k) and busy > 0:
                break
        else:
            raise AssertionError(f"profiler: device work of {k} not recorded")
        device.setdefault(k, []).append(busy / 1e3 / calls(k))
    return ({k: sum(v) / len(v) for k, v in event.items()},
            {k: sum(v) / len(v) for k, v in device.items()})


def spmv_bound(nnz, nrows, ncols, d, itemsize, matrix_bytes=None):
    """(least ms, what bounds it) of y = A x on this card: the matrix read
    once (``matrix_bytes``; by default each nonzero as an int32 column and
    a value, the format-neutral count), x and y once each, against 2 nnz d
    operations at the card's peak non-tensor rate."""
    if matrix_bytes is None:
        matrix_bytes = nnz * (4 + itemsize)
    nbytes = matrix_bytes + (nrows + ncols) * d * itemsize
    flops = 2 * nnz * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / (FP32_FLOPS if itemsize == 4 else FP64_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_tensor(csr, dtype, dev):
    """A scipy csr matrix as a torch sparse CSR tensor on the card (the
    cuSPARSE yardstick)."""
    import torch

    csr = csr.tocsr()
    return torch.sparse_csr_tensor(
        torch.from_numpy(csr.indptr.astype(np.int32)),
        torch.from_numpy(csr.indices.astype(np.int32)),
        torch.from_numpy(csr.data).to(dtype), size=csr.shape,
        check_invariants=False).to(dev)


def library_apply(A_csr, x):
    """cuSPARSE SpMV (d = 1) or SpMM through torch."""
    import torch

    return torch.mv(A_csr, x) if x.ndim == 1 else A_csr @ x


def rel_err(y, ref):
    err = (y - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


class Launches:
    """Per-phase kernel launch counts (reset to 0 before each phase) and
    their sum over the solve phases; for the kernels with epilogues also
    per epilogue (``launches_by_mode``)."""

    NAMES = ("sliced_spmv", "diag_spmv", "shuffle_spmv", "sliced_diag_spmv",
             "halo_spmv")

    def __init__(self, *mods):
        self.mods = dict(zip(self.NAMES, mods))
        self.total = dict.fromkeys(self.NAMES, 0)
        self.total_by_mode = {k: dict.fromkeys(m.launches_by_mode, 0)
                              for k, m in self.mods.items()
                              if hasattr(m, "launches_by_mode")}

    def reset(self):
        for m in self.mods.values():
            m.launches = 0
            if hasattr(m, "launches_by_mode"):
                m.launches_by_mode.update(dict.fromkeys(m.launches_by_mode, 0))

    def read(self):
        got = {k: m.launches for k, m in self.mods.items()}
        for k, v in got.items():
            self.total[k] += v
        for k, total in self.total_by_mode.items():
            for mode, c in self.mods[k].launches_by_mode.items():
                total[mode] += c
        return got

    def by_mode(self):
        """The current per-epilogue counts of the kernels that have them."""
        return {k: dict(self.mods[k].launches_by_mode) for k in self.total_by_mode}


@contextlib.contextmanager
def plain_compositions():
    """The cycle's operations as the kernel's plain SpMV followed by the
    torch ops (``epilogue_plain``), in place of the epilogue launches: the
    reference a fused solve is held against bit for bit.  On the halo path
    the SpMV is the PartitionedOp's plain apply (its interior, then
    halo_spmv's add), and the halo solver's residual numerator is patched
    too.  Patched in here; the package has no switch for it."""
    from gravo_mg_tpu_torch import sparse
    from gravo_mg_tpu_torch.ops.epilogue import epilogue_plain
    from gravo_mg_tpu_torch.parallel import halo
    from gravo_mg_tpu_torch.solver import multigrid as mg
    from gravo_mg_tpu_torch.solver import residual, smoothers

    def cheb_step(A, dinv, b, x, d, c1, c2, keep_d=True):
        return epilogue_plain("cheb", sparse.spmv(A, x), b=b, dinv=dinv, x=x, d=d,
                              c1=c1, c2=c2, keep_d=keep_d)

    def spmv_residual(A, x, b):
        return epilogue_plain("residual", sparse.spmv(A, x), b=b)

    def prolong_add(self, e, x):
        return epilogue_plain("add", sparse.spmv(self.U, e), z=x)

    patches = [(smoothers, "cheb_step", cheb_step), (mg, "spmv_residual", spmv_residual),
               (residual, "spmv_residual", spmv_residual),
               (halo, "spmv_residual", spmv_residual),
               (sparse.ShuffleTransfer, "prolong_add", prolong_add)]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, fn in patches:
        setattr(obj, name, fn)
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def layouts(ctx):
    """Operator and transfer layouts a context planned, e.g.
    A:[SlicedDiag, SlicedEll] U:[ShuffleTransfer]; Prolongation is the
    planner's choice for a transfer of pathological padding."""
    a = [type(lvl.A).__name__ for lvl in ctx.levels]
    u = [type(t).__name__ for t in ctx.transfers]
    return f"A:{a} U:{u}"


def device_events(prof, label):
    """The device's events in a torch.profiler run, without the run's own
    ``record_function`` range ``label``."""
    return [e for e in prof.events()
            if getattr(e.device_type, "name", "") == "CUDA" and e.name != label]


def busy_span(dev):
    """(us the device was busy, us from its first event's start to its
    last event's end) over device events ``dev``."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in dev)
    span = max(max(b for _, b in iv) - iv[0][0], 1e-9)
    busy, cur_a, cur_b = 0.0, iv[0][0], iv[0][1]
    for a, b in iv[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    return busy + cur_b - cur_a, span


def trace_summary(prof, label, cycles):
    """Kernel events of a torch.profiler run: count, time, each SpMV
    kernel's ms per cycle (``cycles`` dispatched) and share of the compute
    kernels (NCCL kernels apart), the device idle share over the span, and
    the largest kernels by time.  ``label`` is the run's
    ``record_function`` range, which the trace also carries on the device
    timeline; it is not a kernel."""
    dev = device_events(prof, label)
    if not dev:
        return "no device events in the trace: not measured"
    busy, span = busy_span(dev)
    kern = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    nccl = [e for e in kern if "nccl" in e.name.lower()]
    comp = [e for e in kern if "nccl" not in e.name.lower()]

    def us(evs):
        return sum(e.time_range.end - e.time_range.start for e in evs)

    by_name: dict = {}
    for e in comp:
        key = e.name.replace("void ", "")[:56]
        by_name[key] = by_name.get(key, 0.0) + e.time_range.end - e.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    comp_us = us(comp)
    per = max(cycles, 1)
    spmv, spmv_us = [], 0.0
    for name in Launches.NAMES:
        # whole identifier: diag_spmv_kernel is inside sliced_diag_spmv_kernel
        pat = re.compile(rf"(?<![A-Za-z_]){name}_kernel")
        evs = [e for e in comp if pat.search(e.name)]
        spmv_us += us(evs)
        spmv.append(f"{name} {len(evs) / per:.1f} launches {us(evs) / 1000 / per:.4f} "
                    f"ms per cycle (share {us(evs) / max(comp_us, 1e-9):.3f})")
    spmv.append(f"all SpMV kernels {spmv_us / 1000 / per:.4f} ms per cycle "
                f"(share {spmv_us / max(comp_us, 1e-9):.3f})")
    return (f"{len(kern)} kernel events ({len(nccl)} NCCL, {us(nccl) / 1000:.3f} ms); "
            f"compute kernel time {comp_us / 1000:.3f} ms over {cycles} dispatched "
            f"cycles ({comp_us / 1000 / per:.4f} ms per cycle, "
            f"{len(comp) / per:.1f} kernels per cycle); " + "; ".join(spmv)
            + f"; device busy {busy / 1000:.3f} of {span / 1000:.3f} ms (idle share "
            f"{1 - busy / span:.3f}); top: "
            + ", ".join(f"{k} {v / 1000:.3f} ms" for k, v in top))


@contextlib.contextmanager
def loop_events():
    """CUDA events on the launching stream around every launch of a WHILE
    graph in the block: the loop's device time, without the profiler's
    own cost; yields the list of (start, end) pairs."""
    import torch
    from gravo_mg_tpu_torch.ops import build

    lib = build.load_library()
    launch = lib.gravomg_graph_loop_launch
    pairs = []

    def timed(exec_, stream):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        err = launch(exec_, stream)
        e1.record()
        pairs.append((e0, e1))
        return err

    lib.gravomg_graph_loop_launch = timed
    try:
        yield pairs
    finally:
        lib.gravomg_graph_loop_launch = launch


def spmv_events(prof, name):
    """Device events of SpMV kernel ``name`` in a torch.profiler run."""
    pat = re.compile(rf"(?<![A-Za-z_]){name}_kernel")
    return sum(1 for e in device_events(prof, "") if pat.search(e.name))


def layout_csr(L):
    """The real entries of a SlicedEll or SlicedDiag on the card as a
    scipy csr matrix (the cuSPARSE yardstick's input)."""
    from gravo_mg_tpu_torch.ops.sliced_diag_spmv import sliced_diag_columns
    from gravo_mg_tpu_torch.ops.sliced_spmv import entry_rows

    cols = (sliced_diag_columns(L.slice_ptr, L.base, L.delta, L.wide_ptr, L.wide_col)
            if hasattr(L, "delta") else L.col.long())
    keep = L.val != 0
    rows = entry_rows(L.slice_ptr)[keep]
    return sp.csr_matrix((L.val[keep].double().cpu().numpy(),
                          (rows.cpu().numpy(), cols[keep].cpu().numpy())),
                         shape=(L.nrows, L.ncols))


def stacked_shuffle(op, p_in, p_out, dev):
    """The interior parts of a DistOp's partitions as one ShuffleEll on the
    card (the layout and route the halo path ran before it moved to the
    sliced layouts): partition j's slots source blocks offset by j * p_in
    / 128 and fill output row groups j * S ..."""
    import torch
    from gravo_mg_tpu_torch.sparse import ShuffleEll

    D, kp, s = op.q.shape
    q = op.q + (np.arange(D, dtype=np.int32) * (p_in // 128))[:, None, None]
    q = np.ascontiguousarray(q.transpose(1, 0, 2)).reshape(kp, D * s)
    r = np.ascontiguousarray(op.r.transpose(1, 0, 2, 3)).reshape(kp, D * s, 128)
    v = np.ascontiguousarray(op.v.transpose(1, 0, 2, 3)).reshape(kp, D * s, 128)
    return ShuffleEll(torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(v),
                      D * p_out, D * p_in).to(dev)


def rel_residual_f64(A, x, b):
    return float(np.linalg.norm(A @ x - b) / np.linalg.norm(b))


def nvidia_smi():
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return smi.stdout.strip() or smi.stderr.strip()


HALO_KW = dict(tol=1e-4, criteria=2, max_iter=50)


def halo_rank_main(rank, world, init_file):
    """One rank of phase halo-multigpu (``chip_smoke.py --halo-rank <rank>
    <world> <init file>``): the 1M Poisson system on this rank's GPU,
    ``4 // world`` of its 4 row partitions, fused and traced, cold and 3
    warm solves each, and the single-device fused solve on the same GPU;
    prints one ``HALO_RANK {json}`` line."""
    import torch
    import torch.distributed as dist
    from gravo_mg_tpu_torch import MultigridSolver
    from gravo_mg_tpu_torch.ops import halo_spmv as hmod
    from gravo_mg_tpu_torch.ops import sliced_diag_spmv as sdmod
    from gravo_mg_tpu_torch.ops import sliced_spmv as slmod
    from gravo_mg_tpu_torch.parallel import multihost
    from gravo_mg_tpu_torch.parallel.halo import HaloContext
    from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg_tpu_torch.utils.meshgen import torus_mesh
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces
    from gravo_mg_tpu_torch.utils.profiler import torch_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    multihost.initialize(init_method=f"file://{init_file}", world_size=world,
                         rank=rank, backend="nccl")
    V, F = torus_mesh(*TORUS_1M)
    n = V.shape[0]
    S, M = cotan_laplacian(V, F), mass_barycentric(V, F)
    lhs = (1e-6 * M + S).tocsr()
    rhs = (M @ np.random.default_rng(42).standard_normal((n, 1)))[:, 0]
    solver = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=1000,
                             device="cuda")
    ctx = solver._context(lhs)
    t0 = time.perf_counter()
    hctx = HaloContext(ctx, multihost.global_row_mesh(4 // world, "cuda"))
    t_build = time.perf_counter() - t0
    remote = sum(len(op.sends) + len(op.recvs)
                 for lvl in hctx.levels for op in (lvl.A, lvl.U.U, lvl.U.UT))
    mods = {"sliced_spmv": slmod, "sliced_diag_spmv": sdmod, "halo_spmv": hmod}
    for m in mods.values():
        m.launches = 0
    x, it, res = hctx.solve(rhs, **HALO_KW)
    launches = {k: m.launches for k, m in mods.items()}
    cold = dict(hctx.timing)
    run0 = hctx.dispatched
    xt, itt, rest = hctx.solve(rhs, mode="traced", **HALO_KW)
    traced_cold = hctx.timing["cycles_ms"]
    warm = {"fused": [], "traced": []}
    warm_loop = []
    for _ in range(3):
        for mode in warm:
            hctx.solve(rhs, mode=mode, **HALO_KW)
            warm[mode].append(hctx.timing["cycles_ms"])
            if mode == "fused":
                warm_loop.append((int(hctx.timing["host_reads"]),
                                  int(hctx.timing["graph_launches"])))
    trace_dir = tempfile.mkdtemp(prefix="gravo_halo_rank_")
    try:
        with torch_trace(trace_dir, name="halo_rank_fused_warm_solve") as prof:
            hctx.solve(rhs, **HALO_KW)
        prof_msg = trace_summary(prof, "halo_rank_fused_warm_solve", hctx.dispatched)
    finally:
        shutil.rmtree(trace_dir, True)
    (loop,) = hctx._fused.values()
    xs, its, _, _ = ctx.solve(rhs, tol=HALO_KW["tol"], mode="fused")
    out = {
        "rank": rank, "world": world, "gpu": torch.cuda.current_device(),
        "partitions": hctx.mesh.n_partitions, "remote_transfers": remote,
        "partition_build_s": t_build, "cycles": it, "res": res,
        "cycles_traced": itt, "res_traced": rest, "cycles_single": its,
        "fused_equals_traced": bool(np.array_equal(x, xt)),
        "rel_vs_single": float(np.abs(x - xs).max() / np.abs(xs).max()),
        "residual_host": solver.residual(lhs, rhs, x), "cycles_run": run0,
        "launches": launches, "captures": loop.graph.captures,
        "builds": loop.graph.builds, "cold_loop": [int(cold["host_reads"]),
                                                   int(cold["graph_launches"])],
        "warm_loop": warm_loop,
        "capture_ms": cold["graph_capture_ms"], "pool_mib": cold["graph_pool_mib"],
        "cold_ms": cold["cycles_ms"], "traced_cold_ms": traced_cold,
        "warm_fused_ms": warm["fused"], "warm_traced_ms": warm["traced"],
        "profile": prof_msg,
    }
    dist.destroy_process_group()
    print("HALO_RANK " + json.dumps(out), flush=True)
    return 0


def multigpu_phase(work_dir, cycles_single=None):
    """Phase halo-multigpu: ``world = 4`` ranks (2 with fewer than 4 GPUs),
    one per GPU, each holding ``4 // world`` of the 1M system's 4 row
    partitions, NCCL point-to-point between the GPUs inside the captured
    halo cycle.  With one GPU it says so and does not run.  Returns
    whether every check passed."""
    import torch

    count = torch.cuda.device_count()
    if count < 2:
        log(f"phase halo-multigpu: {count} GPU present: the phase did not run "
            f"(it needs 2 or more)")
        return True
    world = 4 if count >= 4 else 2
    init_file = os.path.join(work_dir, "rendezvous_multigpu")
    env = dict(os.environ, NCCL_SOCKET_IFNAME="lo")
    env.pop("TORCH_NCCL_BLOCKING_WAIT", None)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--halo-rank", str(r),
         str(world), init_file], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(world)]
    outs = []
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for r, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith("HALO_RANK ")]
        if p.returncode != 0 or not line:
            log(f"phase halo-multigpu: rank {r} failed (rc {p.returncode}):")
            log(out[-6000:])
            return False
        results.append(json.loads(line[-1][len("HALO_RANK "):]))
    r0 = results[0]
    checks = {
        "every rank the same cycles": len({r["cycles"] for r in results}) == 1,
        "cycles == single-device": all(r["cycles"] == r["cycles_single"] for r in results),
        "fused x == traced x (bitwise)": all(r["fused_equals_traced"] for r in results),
        "fused cycles, res == traced": all(
            (r["cycles"], r["res"]) == (r["cycles_traced"], r["res_traced"])
            for r in results),
        "rel vs single < 1e-4": all(r["rel_vs_single"] < 1e-4 for r in results),
        "residual <= 1e-4": all(r["residual_host"] <= 1e-4 for r in results),
        "one capture, one WHILE graph":
            all((r["captures"], r["builds"]) == (1, 1) for r in results),
        "cold: 2 host reads, 1 launch": all(r["cold_loop"] == [2, 1] for r in results),
        "warm: 1 host read, 1 launch":
            all(w == [1, 1] for r in results for w in r["warm_loop"]),
        "remote transfers": all(r["remote_transfers"] > 0 for r in results),
        "sliced_diag_spmv == 10 x cycles run": all(
            r["launches"]["sliced_diag_spmv"] == 10 * r["cycles_run"] for r in results),
        "halo_spmv launched": all(r["launches"]["halo_spmv"] > 0 for r in results),
    }
    if cycles_single is not None:
        checks["cycles within 1 of poisson"] = abs(r0["cycles"] - cycles_single) <= 1
    for r in results:
        log(f"phase halo-multigpu: rank {r['rank']} of {r['world']} on GPU {r['gpu']}, "
            f"{r['partitions']} partitions, {r['remote_transfers']} remote transfers, "
            f"partition build {r['partition_build_s']:.2f} s; cycles {r['cycles']} "
            f"(single-device {r['cycles_single']}) residual(host f64) "
            f"{r['residual_host']:.3e} rel vs single {r['rel_vs_single']:.3e}; fused "
            f"cold {r['cold_ms']:.2f} ms (capture {r['capture_ms']:.1f} ms, pool "
            f"{r['pool_mib']:.1f} MiB), warm {', '.join(f'{w:.3f}' for w in r['warm_fused_ms'])} "
            f"ms; traced cold {r['traced_cold_ms']:.2f} ms, warm "
            f"{', '.join(f'{w:.3f}' for w in r['warm_traced_ms'])} ms; launches "
            f"{r['launches']}")
    log(f"phase halo-multigpu: rank 0 fused warm solve under the profiler: {r0['profile']}")
    ok = all(checks.values())
    log(f"phase halo-multigpu: {world} ranks on {count} GPUs in "
        f"{time.perf_counter() - t0:.1f} s; checks "
        f"{[k for k, v in checks.items() if not v] or 'all passed'} "
        f"{'ok' if ok else 'FAIL'}")
    return ok


def comparisons_phase(work_dir):
    """Phase comparisons: the port's harness
    (``gravo_mg_tpu_torch.experiments.comparisons``) at its default
    generated sizes on the card, with the device loop (``--mode fused``):
    direct, SIG21, SIG06, CG and ours, then the ablation hierarchy in the
    ours slot, 3 repetitions each, and the table generator.  Returns
    whether every row met tol."""
    from gravo_mg_tpu_torch.experiments import comparisons

    ok = True
    for label, extra in (("laplacian", ["--sig06", "--direct", "--cg"]),
                         ("ablation", ["--ablation", "--nosig21"])):
        out = os.path.join(work_dir, "comparisons", "timing")
        t0 = time.perf_counter()
        # the harness's own progress lines go to a file beside its CSVs
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, f"{label}.log"), "w") as fh, \
                contextlib.redirect_stdout(fh):
            table = comparisons.main(["--label", label, "--out_dir", out,
                                      "--num_repetitions", "3", "--device", "cuda",
                                      "--mode", "fused", *extra])
        wall = time.perf_counter() - t0
        ours, loops = {}, []
        for name in os.listdir(out):
            if not name.startswith("solver_") or not name.endswith(f"_{label}.csv"):
                continue
            with open(os.path.join(out, name)) as fh:
                head = fh.readline().strip().split(",")
                for line in fh:
                    row = dict(zip(head, line.strip().split(",")))
                    if "warm_graph_launches" in row:   # a multigrid solve
                        loops.append((name, row["experiment"], row["graph_launches"],
                                      row["warm_host_reads"],
                                      row["warm_graph_launches"]))
                    if name.startswith("solver_ours_"):
                        ours.setdefault(row["experiment"], []).append(
                            (float(row["cycles"]), float(row["warm_cycles"])))
        # every multigrid solve: one WHILE-graph launch, cold and warm; the
        # warm one waits on the host once
        bad = [r for r in loops if tuple(float(v) for v in r[2:]) != (1.0, 1.0, 1.0)]
        ok &= bool(loops) and not bad
        log(f"phase comparisons: {label}: {len(loops)} multigrid solves, each one graph "
            f"launch cold and warm and one host read warm: "
            f"{'yes' if loops and not bad else f'NO {bad[:4]}'}")
        for row in table:
            keys = [k for k in ("mean_residue", "sig06_residue", "sig21_residue")
                    if k in row]
            this_ok = all(row[k] <= 1e-4 for k in keys)
            ok &= this_ok
            exp = row["experiment"].lower().replace(" ", "_")
            log(f"phase comparisons: {label} {row['experiment']} ({row['n_vertices']}): "
                f"hierarchy {row['mean_hierarchy']:.3f} s, cycles "
                f"{row['mean_iterations']:g}, solve {row['mean_solver']:.4f} s, "
                f"device loop cold / warm ms "
                f"{[f'{c:.2f} / {w:.2f}' for c, w in ours.get(exp, [])]}, residue "
                f"{row['mean_residue']:.2e}"
                + "".join(f"; {p.upper()} hierarchy {row[p + '_hierarchy']:.3f} s cycles "
                          f"{row[p + '_iterations']:g} solve {row[p + '_solver']:.4f} s "
                          f"residue {row[p + '_residue']:.2e}"
                          for p in ("sig21", "sig06") if p + "_residue" in row)
                + (f"; CG {row['cg_solver']:.1f} ms" if "cg_solver" in row else "")
                + (f"; direct factor {row['direct_factor']:.3f} s solve "
                   f"{row['direct_solve']:.4f} s" if "direct_factor" in row else "")
                + f" {'ok' if this_ok else 'FAIL'}")
        log(f"phase comparisons: {label}: {len(table)} shapes in {wall:.1f} s")
    return ok


def multigpu_main():
    """``chip_smoke.py --multigpu-only``: build the libraries, then phase
    halo-multigpu alone (for a machine with several GPUs)."""
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        return 2
    from gravo_mg_tpu_torch import native
    from gravo_mg_tpu_torch.ops import build

    log(f"nvidia-smi: {nvidia_smi()}")
    native.get_lib()
    build.build_library()
    work_dir = tempfile.mkdtemp(prefix="gravo_halo_")
    try:
        ok = multigpu_phase(work_dir)
    finally:
        shutil.rmtree(work_dir, True)
    if not ok:
        log("FAILED phase halo-multigpu")
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        return 2
    import gravo_mg_tpu_torch  # noqa: F401  (fails outside the repository)
    from gravo_mg_tpu_torch import (
        Hierarchy, MinQuadWithFixedMG, MultigridSolver, native, sparse,
    )
    from gravo_mg_tpu_torch.models import ConformalFlow
    from gravo_mg_tpu_torch.ops import build
    from gravo_mg_tpu_torch.ops import diag_spmv as dmod
    from gravo_mg_tpu_torch.ops import halo_spmv as hmod
    from gravo_mg_tpu_torch.ops import shuffle_spmv as smod
    from gravo_mg_tpu_torch.ops import sliced_diag_spmv as sdmod
    from gravo_mg_tpu_torch.ops import sliced_spmv as slmod
    from gravo_mg_tpu_torch.ops.epilogue import epilogue_plain, masked_rows
    from gravo_mg_tpu_torch.parallel.halo import (
        PartitionedOp, _build_dist_op, _halo_plan, make_solver_mesh, partition_rows,
    )
    from gravo_mg_tpu_torch.solver.direct import cg_operator
    from gravo_mg_tpu_torch.solver import direct as cg_direct
    from gravo_mg_tpu_torch.solver.device_loop import StepGraph
    from gravo_mg_tpu_torch.solver.multigrid import release_loops
    from gravo_mg_tpu_torch.sparse import (
        DiagEll, ShuffleTransfer, SlicedDiag, SlicedEll, diag_plan_arrays,
        ell_from_scipy, shuffle_from_scipy, sliced_bytes, sliced_diag_bytes, sliced_from_scipy,
    )
    from gravo_mg_tpu_torch.utils.laplacian import (
        cotan_laplacian, mass_barycentric, mass_voronoi,
    )
    from gravo_mg_tpu_torch.utils.meshgen import icosphere, torus_mesh
    from gravo_mg_tpu_torch.utils.neighbors import (
        neighbors_from_faces, neighbors_from_stiffness,
    )
    from gravo_mg_tpu_torch.utils.normalize import normalize_area
    from gravo_mg_tpu_torch.utils.profiler import torch_trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    log(f"nvidia-smi: {nvidia_smi()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda")
    counts = Launches(slmod, dmod, smod, sdmod, hmod)
    trace_dir = tempfile.mkdtemp(prefix="gravo_trace_")
    atexit.register(shutil.rmtree, trace_dir, True)

    # ---- 1. build ----------------------------------------------------------
    try:
        t_wall = time.perf_counter()
        t0 = time.perf_counter()

        def timed(fn):
            t = time.perf_counter()
            fn()
            return time.perf_counter() - t

        with ThreadPoolExecutor(max_workers=2) as pool:
            f_native = pool.submit(timed, native.get_lib)
            f_cuda = pool.submit(timed, build.build_library)
            t_native, t_cuda = f_native.result(), f_cuda.result()
        build.load_library()
        ptxas = [ln.strip() for ln in build.build_log.splitlines()
                 if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln)]
        log(f"phase build: native g++ {t_native:.1f} s, nvcc ({build.ARCH}) "
            f"{t_cuda:.1f} s, both at once {time.perf_counter() - t0:.1f} s "
            f"-> {build.LIBRARY.name}")
        for ln in ptxas:
            log(f"  {ln}")
        log(f"build: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001 — report and exit non-zero
        fail("build", exc)

    # ---- 1M system, hierarchy and setup (operators for phases 2 and 4-7) --
    try:
        t_wall = time.perf_counter()
        t0 = time.perf_counter()
        V, F = torus_mesh(*TORUS_1M)
        n = V.shape[0]
        S = cotan_laplacian(V, F)
        M = mass_barycentric(V, F)
        neigh = neighbors_from_faces(F)
        lhs = (1e-6 * M + S).tocsr()
        rhs = (M @ np.random.default_rng(42).standard_normal((n, 1)))[:, 0]
        lhs_cg = (M + 1e-3 * S).tocsr()
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        solver = MultigridSolver(V, neigh, M, lower_bound=1000, device="cuda")
        t_hier = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx = solver._context(lhs)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        A_cg = cg_operator(lhs_cg).to(dev)
        # MinQuad's reduced context (phase minquad; its finest level is a
        # phase-kernels operator)
        rng3 = np.random.default_rng(3)
        known = rng3.choice(n, size=n // 20, replace=False)
        Y = rng3.standard_normal(known.size)
        B = M @ rng3.standard_normal(n)
        lhs_mq = (S + 1e-3 * M).tocsr()
        resident = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        mq = MinQuadWithFixedMG(solver, lhs_mq, known, tol=1e-4, max_iter=20,
                                criteria=2)
        torch.cuda.synchronize()
        t_pre = time.perf_counter() - t0
        # held through phase poisson; its peak is also given without it
        mq_mib = (torch.cuda.memory_allocated() - resident) / 2**20
        log(f"1M system: n={n} nnz={lhs.nnz} mesh+operators {t_mesh:.2f} s, "
            f"hierarchy {t_hier:.2f} s, setup {t_setup:.2f} s; "
            f"CG operator {type(A_cg).__name__}; MinQuad precompute {t_pre:.2f} s")
        log("1M system: setup ms " + ", ".join(
            f"{k} {ctx.timing[k]:.0f}" for k in (
                "setup_shuffle_layout", "setup_transfers", "setup_csr_src",
                "reduction", "plan_build") if k in ctx.timing))
        log(f"poisson-setup: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("poisson-setup", exc)

    # ---- 262k baselines: mesh, the four hierarchies and their contexts -----
    try:
        t_wall = time.perf_counter()
        t0 = time.perf_counter()
        Vb, Fb = torus_mesh(*TORUS_262K, r=0.5)
        Vb = normalize_area(Vb, Fb)
        Sb, Mb = cotan_laplacian(Vb, Fb), mass_voronoi(Vb, Fb)
        neigh_b = neighbors_from_stiffness(Sb)
        lhs_b = (Mb + 1e-3 * Sb).tocsr()
        rhs_b = Mb @ np.random.default_rng(0).standard_normal((Vb.shape[0], 1))
        log(f"262k system: n={Vb.shape[0]} mesh+operators "
            f"{time.perf_counter() - t0:.2f} s")
        baselines = {}
        for name, kw in (("ours", {}), ("sig06", {"sig06": True}),
                         ("ablation", {"ablation": True}), ("sig21", None)):
            t0 = time.perf_counter()
            if kw is None:   # SIG21 through the facade's toggle, on a solver
                # of its own so that OURS keeps its context
                s = MultigridSolver(Vb, neigh_b, Mb, device="cuda")
                t0 = time.perf_counter()
                s.construct_sig21_hierarchy(Fb)
                s.toggle_hierarchy(Hierarchy.SIG21)
            else:
                s = MultigridSolver(Vb, neigh_b, Mb, device="cuda", **kw)
            t_h = time.perf_counter() - t0
            t0 = time.perf_counter()
            c = s._context(lhs_b)
            torch.cuda.synchronize()
            baselines[name] = {"solver": s, "ctx": c, "hierarchy_s": t_h,
                               "setup_s": time.perf_counter() - t0,
                               "dof": list(s.hierarchy.dof)}
        # The SIG21 finest transfer as the solver planned it (a SlicedEll
        # pair, or a Prolongation past the padding cap; then built here).
        t21 = baselines["sig21"]["ctx"].transfers[0]
        sig21_UT_csr = baselines["sig21"]["ctx"].U_csr[0].T.tocsr()
        sig21_U0T = (t21.UT if isinstance(t21, ShuffleTransfer)
                     else sliced_from_scipy(sig21_UT_csr).to(dev))
        log(f"baselines-setup: SIG21 finest transfer {type(t21).__name__}")
        log(f"baselines-setup: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("baselines-setup", exc)

    # ---- 2. kernels vs plain ---------------------------------------------
    # Every SlicedEll operator of the 1M context, CG's and SIG21's finest
    # restriction: sliced_spmv ("new") beside shuffle_spmv on the JAX
    # package's layout of the same matrix ("old", the route it replaced),
    # both plain versions and cuSPARSE ("library"), timed in turns.
    sliced_cases = [(f"A{k}", lvl.A, ctx.chain_csr[k])
                    for k, lvl in enumerate(ctx.levels) if k > 0]
    for k, t in enumerate(ctx.transfers):
        sliced_cases += [(f"U{k}T", t.UT, ctx.U_csr[k].T.tocsr()),
                         (f"U{k}", t.U, ctx.U_csr[k])]
    # CG's operator is SlicedDiag (the byte rule); its SlicedEll layout
    # stays here as the sliced route's largest case
    sliced_cases += [("M", ctx.M, ctx.mass_csr),
                     ("CG M+1e-3S", sliced_from_scipy(lhs_cg).to(dev), lhs_cg),
                     ("SIG21-262k U0T", sig21_U0T, sig21_UT_csr)]
    loop_info = {}     # the WHILE graph of phase poisson's fused solves
    kinfo = {name: {"err": 0.0, "ms": None, "plain_ms": None, "bound_ms": None,
                    "bound_by": None, "library_ms": None, "epilogues": {}}
             for name in Launches.NAMES}

    def keep(name, err, ms=None, plain_ms=None, bound=None, library_ms=None):
        info = kinfo[name]
        info["err"] = max(info["err"], err)
        if ms is not None:
            info.update(ms=ms, plain_ms=plain_ms, bound_ms=bound[0],
                        bound_by=bound[1], library_ms=library_ms)

    # applies per V-cycle of the 1M context (d = 1): each level's A in the
    # smoother sweeps and its residual, each transfer once, M once in the
    # criterion-2 residual check
    cfg = ctx.cfg
    per_cycle = {f"A{k}": cfg.pre_iters + cfg.post_iters + 1
                 for k in range(1, len(ctx.levels))}
    for k in range(len(ctx.transfers)):
        per_cycle.update({f"U{k}T": 1, f"U{k}": 1})
    per_cycle["M"] = 1
    cycle = {"new": 0.0, "old": 0.0, "library": 0.0, "bound": 0.0,
             "new MB": 0.0, "old MB": 0.0}
    rng = np.random.default_rng(0)
    try:
        t_wall = time.perf_counter()
        for label, A, csr in sliced_cases:
            if not isinstance(A, SlicedEll):
                raise AssertionError(f"{label} is a {type(A).__name__}, not SlicedEll")
            inf = A.info()
            sh = shuffle_from_scipy(csr).to(dev)        # the JAX package's layout
            lib = csr_tensor(csr, torch.float32, dev)
            kp, lanes = sh.q.shape[0], sh.r.numel()
            log(f"phase kernels: {label} rows {A.nrows} cols {A.ncols} nnz {A.nnz}; "
                f"sliced {inf['entries']} entries ({inf['padding']:.2f}x nnz), "
                f"widest slice {inf['max_width']}, {A.tpr} threads per row; "
                f"shuffle KP {kp}, {lanes} slot lanes ({lanes / max(A.nnz, 1):.2f}x nnz)")
            for d in (1, 3):
                xs = rng.standard_normal((A.ncols,) if d == 1 else (A.ncols, d))
                x = torch.from_numpy(xs).to(dev, torch.float32)
                fns = {
                    "new": lambda: slmod.sliced_spmv(A.slice_ptr, A.col, A.val, x,
                                                     A.nrows, A.tpr),
                    "old": lambda: smod.shuffle_spmv(sh.q, sh.r, sh.v, x, sh.nrows),
                    "library": lambda: library_apply(lib, x),
                    "plain": lambda: slmod.sliced_spmv_plain(A.slice_ptr, A.col,
                                                             A.val, x, A.nrows),
                    "old plain": lambda: smod.shuffle_spmv_plain(sh.q, sh.r, sh.v,
                                                                 x, sh.nrows),
                }
                ys = {k: f() for k, f in fns.items()}
                torch.cuda.synchronize()
                errs = {
                    "vs plain": rel_err(ys["new"], ys["plain"]),
                    "vs old": rel_err(ys["new"], ys["old"]),
                    "vs old plain": rel_err(ys["new"], ys["old plain"]),
                    "old vs its plain": rel_err(ys["old"], ys["old plain"]),
                    "library vs plain": rel_err(ys["library"], ys["plain"]),
                }
                ok = (all(r <= TOL_F32 for _, r in errs.values())
                      and bool(torch.isfinite(ys["new"]).all()))
                ev, ms = time_in_turns(fns, ["old", "new", "library", "plain",
                                             "old plain", "library", "new", "old"])
                bound = spmv_bound(A.nnz, A.nrows, A.ncols, d, 4)
                log(f"phase kernels: sliced_spmv {label} d={d} f32 device us: new "
                    f"{ms['new'] * 1e3:.2f}, old shuffle_spmv {ms['old'] * 1e3:.2f}, "
                    f"library (cuSPARSE) {ms['library'] * 1e3:.2f}, plain "
                    f"{ms['plain'] * 1e3:.1f}, old plain {ms['old plain'] * 1e3:.1f} "
                    f"(events per call: new {ev['new'] * 1e3:.2f}, old {ev['old'] * 1e3:.2f}, "
                    f"library {ev['library'] * 1e3:.2f}); bound {bound[0] * 1e3:.2f} us "
                    f"({bound[1]}), share of bound new {bound[0] / ms['new']:.3f} old "
                    f"{bound[0] / ms['old']:.3f} library {bound[0] / ms['library']:.3f}; "
                    f"rel err "
                    + ", ".join(f"{k} {r:.2e}" for k, (_, r) in errs.items())
                    + f" (tol {TOL_F32}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"sliced_spmv {label} d={d} disagrees")
                if d == 1:
                    # device time of every threads-per-row variant
                    sweep = {f"tpr {t}": (lambda t=t: slmod.sliced_spmv(
                        A.slice_ptr, A.col, A.val, x, A.nrows, t)) for t in slmod.TPRS}
                    _, tms = time_in_turns(sweep, list(sweep))
                    log(f"phase kernels: sliced_spmv {label} d=1 f32 device us by threads "
                        "per row: " + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in tms.items())
                        + f" (planned: tpr {A.tpr})")
                if d == 1 and label in per_cycle:
                    w = per_cycle[label]
                    for k in ("new", "old", "library"):
                        cycle[k] += w * ms[k]
                    cycle["bound"] += w * bound[0]
                    cycle["new MB"] += w * A.col.numel() * 8 / 1e6
                    cycle["old MB"] += w * lanes * 5 / 1e6
                first = d == 1 and label == "U0T"
                keep("sliced_spmv", errs["vs plain"][0],
                     *((ms["new"], ms["plain"], bound, ms["library"]) if first else ()))
                keep("shuffle_spmv", errs["old vs its plain"][0],
                     *((ms["old"], ms["old plain"], bound, ms["library"])
                       if first else ()))
                del x, ys, fns
            # f64: the same layouts with values widened exactly
            x = torch.from_numpy(rng.standard_normal(A.ncols)).to(dev)
            v64, sv64 = A.val.double(), sh.v.double()
            y = slmod.sliced_spmv(A.slice_ptr, A.col, v64, x, A.nrows, A.tpr)
            rels = [rel_err(y, ref)[1] for ref in (
                slmod.sliced_spmv_plain(A.slice_ptr, A.col, v64, x, A.nrows),
                smod.shuffle_spmv(sh.q, sh.r, sv64, x, sh.nrows),
                smod.shuffle_spmv_plain(sh.q, sh.r, sv64, x, sh.nrows))]
            log(f"phase kernels: sliced_spmv {label} d=1 f64 rel err vs plain "
                f"{rels[0]:.2e}, vs old {rels[1]:.2e}, vs old plain {rels[2]:.2e} "
                f"(tol {TOL_F64})")
            if not max(rels) <= TOL_F64:
                raise AssertionError(f"sliced_spmv {label} f64 disagrees")
            del x, v64, sv64, y, sh, lib

        log(f"phase kernels: 1M Poisson V-cycle, its {sum(per_cycle.values())} "
            f"SlicedEll applies at d=1 (" + ", ".join(
                f"{k} x{w}" for k, w in per_cycle.items())
            + f"): device ms per cycle new sliced_spmv {cycle['new']:.4f}, old "
            f"shuffle_spmv {cycle['old']:.4f}, library (cuSPARSE) "
            f"{cycle['library']:.4f}, bound {cycle['bound']:.4f}; streamed per cycle "
            f"{cycle['new MB']:.1f} MB of sliced (col, val) against {cycle['old MB']:.1f} "
            "MB of ShuffleEll (v, r)")

        # The SlicedDiag operators through sliced_diag_spmv, beside diag_spmv
        # on A0's DiagEll (the route they replaced; the planner no longer
        # builds it), cuSPARSE and the plain version.
        chain0 = ctx.chain_csr[0]
        E0 = ell_from_scipy(chain0, dtype=torch.float64)
        idx0 = E0.indices.numpy()
        mask0 = np.arange(idx0.shape[0])[:, None] < np.diff(chain0.indptr)[None, :]
        t0 = time.perf_counter()
        start, tg, r0, src0 = diag_plan_arrays(idx0, mask0, chain0.shape[1])
        t_old_layout = time.perf_counter() - t0
        t0 = time.perf_counter()
        if ctx._plan_level(chain0)[0] != "sdiag":
            raise AssertionError("the planner no longer picks SlicedDiag for A0")
        t_new_layout = time.perf_counter() - t0
        v0 = np.append(E0.values.numpy().reshape(-1), 0.0)[src0]
        D0 = DiagEll(torch.from_numpy(start), torch.from_numpy(r0),
                     torch.from_numpy(v0.astype(np.float32)), tg, *chain0.shape).to(dev)
        del E0, idx0, mask0, r0, src0, v0
        log(f"phase kernels: A0 layout on the host: diag_plan_arrays (DiagEll, "
            f"what the planner built before) {t_old_layout:.2f} s, "
            f"the planner's SlicedDiag plan (_plan_level) {t_new_layout:.2f} s; "
            f"the 1M context's "
            f"setup_shuffle_layout {ctx.timing['setup_shuffle_layout']:.0f} ms")
        sdiag_cases = [("A0", ctx.levels[0].A, chain0, D0),
                       ("CG M+1e-3S", A_cg, lhs_cg, None),
                       ("MinQuad A0", mq.ctx.levels[0].A, mq.ctx.chain_csr[0], None)]
        for label, A, csr, D in sdiag_cases:
            if not isinstance(A, SlicedDiag):
                raise AssertionError(f"{label} is a {type(A).__name__}, not SlicedDiag")
            inf = A.info()
            ptr, wptr = A.slice_ptr.cpu().numpy(), A.wide_ptr.cpu().numpy()
            io = (A.nrows + A.ncols) * 4
            old_mb = f", DiagEll (v, r) {D.r.numel() * 5 / 1e6:.1f} MB (KP {D.r.shape[0]}, " \
                f"tg {D.tg})" if D is not None else ""
            log(f"phase kernels: {label} rows {A.nrows} nnz {A.nnz} entries {inf['entries']} "
                f"({inf['padding']:.3f}x nnz), slices {inf['slices']}, wide slices "
                f"{inf['wide_slices']}, widest {A.wmax}; "
                f"bytes per f32 apply with x and y: sliced_diag {inf['bytes'] / 1e6:.2f} MB, "
                f"SlicedEll {(sliced_bytes(ptr, 4) + io) / 1e6:.2f} MB, format-neutral "
                f"(nnz 8 B) {(A.nnz * 8 + io) / 1e6:.2f} MB"
                + old_mb)
            runs = [(torch.float32, 1), (torch.float64, 1)]
            if label == "A0":   # d = 3 in f64 is what the flow's cycles run
                runs = [(torch.float32, 1), (torch.float32, 3), (torch.float64, 1),
                        (torch.float64, 3)]
            csr = csr.copy()        # cuSPARSE's values as the layout holds them
            csr.data = csr.data.astype(np.float32)
            for dtype, d in runs:
                item = 4 if dtype == torch.float32 else 8
                tol = TOL_F32 if dtype == torch.float32 else TOL_F64
                val = A.val.to(dtype)          # f64: the same values widened
                lib = csr_tensor(csr, dtype, dev)
                xs = rng.standard_normal((A.ncols,) if d == 1 else (A.ncols, d))
                x = torch.from_numpy(xs).to(dev, dtype)
                args = (A.slice_ptr, A.base, A.delta, val, A.wide_ptr, A.wide_col)
                fns = {"kernel": lambda: sdmod.sliced_diag_spmv(*args, x, A.nrows),
                       "library": lambda: library_apply(lib, x),
                       "plain": lambda: sdmod.sliced_diag_spmv_plain(*args, x, A.nrows)}
                order = ["kernel", "library", "plain"]
                if D is not None:
                    dv = D.v.to(dtype)
                    fns["old"] = lambda: dmod.diag_spmv(D.start, D.r, dv, x, D.tg, D.nrows)
                    fns["old plain"] = lambda: dmod.diag_spmv_plain(D.start, D.r, dv, x,
                                                                    D.tg, D.nrows)
                    order += ["old", "old plain"]
                order += ["library", "kernel"] + (["old"] if D is not None else [])
                ys = {k: f() for k, f in fns.items()}
                torch.cuda.synchronize()
                errs = {k: rel_err(ys[k], ys["plain"]) for k in fns if k != "plain"}
                if D is not None:
                    errs["old vs its plain"] = rel_err(ys["old"], ys["old plain"])
                ok = (all(r <= tol for _, r in errs.values())
                      and bool(torch.isfinite(ys["kernel"]).all()))
                ev, ms = time_in_turns(fns, order)
                own = spmv_bound(A.nnz, A.nrows, A.ncols, d, item,
                                 sliced_diag_bytes(ptr, wptr, item))
                neutral = spmv_bound(A.nnz, A.nrows, A.ncols, d, item)
                timed = [k for k in ("kernel", "old", "library") if k in ms]
                dt = "f32" if item == 4 else "f64"
                log(f"phase kernels: sliced_diag_spmv {label} d={d} {dt} device us: "
                    + ", ".join(f"{k} {ms[k] * 1e3:.2f}" for k in timed)
                    + f", plain {ms['plain'] * 1e3:.1f}"
                    + (f", old plain {ms['old plain'] * 1e3:.1f}" if D is not None else "")
                    + " (events per call: " + ", ".join(
                        f"{k} {ev[k] * 1e3:.2f}" for k in timed)
                    + f"); bound of this layout {own[0] * 1e3:.2f} us ({own[1]}), "
                    f"format-neutral bound {neutral[0] * 1e3:.2f} us ({neutral[1]}); "
                    "share of the layout's bound " + ", ".join(
                        f"{k} {own[0] / ms[k]:.3f}" for k in timed)
                    + "; of the format-neutral bound " + ", ".join(
                        f"{k} {neutral[0] / ms[k]:.3f}" for k in timed)
                    + "; max_abs_err / rel vs plain " + ", ".join(
                        f"{k} {a:.3e} / {r:.3e}" for k, (a, r) in errs.items())
                    + f" (tol {tol}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"sliced_diag_spmv {label} d={d} {dt} disagrees")
                keep("sliced_diag_spmv", errs["kernel"][0],
                     *((ms["kernel"], ms["plain"], own, ms["library"])
                       if (label, d, item) == ("A0", 1, 4) else ()))
                if D is not None:
                    keep("diag_spmv", errs["old vs its plain"][0],
                         *((ms["old"], ms["old plain"], neutral, ms["library"])
                           if (d, item) == (1, 4) else ()))
                if (label, d) == ("A0", 1):
                    log(f"phase kernels: A0 {dt} per 1M V-cycle (10 applies): "
                        + ", ".join(f"{k} {10 * ms[k]:.4f} ms" for k in timed))
                del x, ys, fns, lib, val
        del D0, sdiag_cases

        # The epilogues (ops/epilogue.py): each operation of the cycle as one
        # launch ("fused") beside the kernel's plain-mode SpMV followed by the
        # torch ops ("composed", its bitwise reference), the bare SpMV and
        # the plain version (the plain SpMV and the same torch ops), on A0
        # (sliced_diag_spmv), A1 and U0 (sliced_spmv); d = 1 in f32 (the
        # Poisson cycle) and d = 3 in f64 (the flow's).  Bound: the SpMV's
        # matrix bytes (SlicedDiag: its layout's own, as the plain A0 row;
        # SlicedEll: format-neutral, below its layout's) plus x and the
        # vectors the epilogue reads and writes, each once; for SlicedDiag
        # the format-neutral bound beside it.  Library: the residual as
        # torch.addmv/addmm(b, A, x, alpha=-1) and the add as
        # torch.addmv/addmm(z, U, e) on the same CSR (cuSPARSE); no single
        # PyTorch call computes a Chebyshev step.
        epi_cases = ([("A0", ctx.levels[0].A, chain0, op) for op in EPI_OPS]
                     + [("A1", ctx.levels[1].A, ctx.chain_csr[1], op) for op in EPI_OPS]
                     + [("U0", ctx.transfers[0].U, ctx.U_csr[0], "add")])
        # operations per 1M V-cycle (the residual once more in the criterion)
        epi_cycle = {"cheb_first": 2, "cheb_next": 6, "residual": 2}
        epi_sum = {}

        def epilogue_case(label, A, csr, op, dtype, d):
            """One operation's timings and checks; its tensors die with the
            call (phase poisson's peak memory must not count them)."""
            name = "sliced_diag_spmv" if isinstance(A, SlicedDiag) else "sliced_spmv"
            item = 4 if dtype == torch.float32 else 8
            tol = TOL_F32 if item == 4 else TOL_F64
            Aop = dataclasses.replace(A, val=A.val.to(dtype))

            def vec(rows, scale=1.0):
                v = scale * rng.standard_normal((rows,) if d == 1 else (rows, d))
                return torch.from_numpy(v).to(dev, dtype)

            def spmv_plain(v):
                if isinstance(A, SlicedDiag):
                    return sdmod.sliced_diag_spmv_plain(
                        A.slice_ptr, A.base, A.delta, Aop.val, A.wide_ptr, A.wide_col,
                        v, A.nrows)
                return slmod.sliced_spmv_plain(A.slice_ptr, A.col, Aop.val, v, A.nrows)

            x = vec(A.ncols)
            vb = A.nrows * d * item            # one vector the shape of y
            library = None
            if op in ("add", "residual"):
                csr = csr.copy()               # cuSPARSE's values as the layout holds them
                csr.data = csr.data.astype(np.float32)
                lib = csr_tensor(csr, dtype, dev)
                addm = torch.addmv if d == 1 else torch.addmm
            if op == "add":
                z = vec(A.nrows)
                mode, kw, extra = "add", {"z": z}, vb
                fused = once = lambda: sparse.spmv_add(Aop, x, z)   # noqa: E731
                library = lambda: addm(z, lib, x)   # noqa: E731
            elif op == "residual":
                b = vec(A.nrows)
                mode, kw, extra = "residual", {"b": b}, vb
                fused = once = lambda: sparse.spmv_residual(Aop, x, b)   # noqa: E731
                library = lambda: addm(b, lib, x, alpha=-1)   # noqa: E731
            else:
                first = op == "cheb_first"
                b, d_prev = vec(A.nrows), vec(A.nrows, 0.1)
                dinv = torch.from_numpy(0.5 + rng.random(A.nrows)).to(dev, dtype)
                c1 = None if first else EPI_C1
                mode = "cheb"
                kw = {"b": b, "dinv": dinv, "x": x, "d": None if first else d_prev,
                      "c1": c1, "c2": EPI_C2}
                # b, dinv, d written (and read unless first)
                extra = 2 * vb + A.nrows * item + (0 if first else vb)
                d_work = d_prev.clone()
                fused = lambda: sparse.cheb_step(   # noqa: E731
                    Aop, dinv, b, x, None if first else d_work, c1, EPI_C2)
                once = lambda: sparse.cheb_step(   # noqa: E731
                    Aop, dinv, b, x, None if first else d_prev.clone(), c1, EPI_C2)
            fns = {"fused": fused,
                   "composed": lambda: epilogue_plain(mode, sparse.spmv(Aop, x), **kw),
                   "spmv": lambda: sparse.spmv(Aop, x),
                   "plain": lambda: epilogue_plain(mode, spmv_plain(x), **kw)}
            order = ["fused", "composed", "spmv", "plain", "spmv", "composed", "fused"]
            if library is not None:
                fns["library"] = library
                order[3:3] = ["library"]
                order.append("library")
            got, composed, plain_v = (
                r if isinstance(r, tuple) else (r,)
                for r in (once(), fns["composed"](), fns["plain"]()))
            lib_y = library() if library is not None else None
            torch.cuda.synchronize()
            bitwise = all(torch.equal(g, c) for g, c in zip(got, composed))
            err, rel = rel_err(got[0], plain_v[0])
            lib_err = rel_err(lib_y, plain_v[0]) if lib_y is not None else None
            ok = (bitwise and rel <= tol and bool(torch.isfinite(got[0]).all())
                  and (lib_err is None or lib_err[1] <= tol))
            ev, ms = time_in_turns(fns, order)
            if isinstance(A, SlicedDiag):
                matrix = sliced_diag_bytes(A.slice_ptr.cpu().numpy(),
                                           A.wide_ptr.cpu().numpy(), item)
            else:
                matrix = A.nnz * (4 + item)
            bound = spmv_bound(A.nnz, A.nrows, A.ncols, d, item, matrix + extra)
            neutral = spmv_bound(A.nnz, A.nrows, A.ncols, d, item,
                                 A.nnz * (4 + item) + extra)
            nbytes = matrix + extra + (A.nrows + A.ncols) * d * item
            lib_ms = ms.get("library")
            dt = "f32" if item == 4 else "f64"
            log(f"phase kernels: epilogue {name} {label} {op} d={d} {dt} device us: "
                f"fused {ms['fused'] * 1e3:.2f}, composed (kernel SpMV + torch ops) "
                f"{ms['composed'] * 1e3:.2f}, bare SpMV {ms['spmv'] * 1e3:.2f}, "
                + (f"library (cuSPARSE addmv/addmm) {lib_ms * 1e3:.2f}, "
                   if lib_ms is not None else "library none, ")
                + f"plain version {ms['plain'] * 1e3:.1f} (events per call: fused "
                f"{ev['fused'] * 1e3:.2f}, composed {ev['composed'] * 1e3:.2f}); "
                f"fused bytes {nbytes / 1e6:.2f} MB, bound {bound[0] * 1e3:.2f} us "
                f"({bound[1]}), share fused {bound[0] / ms['fused']:.3f} composed "
                f"{bound[0] / ms['composed']:.3f}"
                + (f"; format-neutral bound {neutral[0] * 1e3:.2f} us, share fused "
                   f"{neutral[0] / ms['fused']:.3f}" if isinstance(A, SlicedDiag) else "")
                + f"; max_abs_err {err:.3e} rel {rel:.3e} vs plain (tol {tol})"
                + (f", library {lib_err[0]:.3e} rel {lib_err[1]:.3e}"
                   if lib_err is not None else "")
                + f"; bitwise equal to the composition {bitwise} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"epilogue {name} {label} {op} d={d} {dt} disagrees")
            keep(name, err)
            if (d, item) == (1, 4):
                kinfo[name]["epilogues"][f"{label} {op}"] = {
                    "ms": ms["fused"], "composed_ms": ms["composed"],
                    "spmv_ms": ms["spmv"], "plain_ms": ms["plain"],
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "library_ms": lib_ms, "max_abs_err": err, "bitwise": bitwise}
                if isinstance(A, SlicedDiag):
                    kinfo[name]["epilogues"][f"{label} {op}"]["neutral_bound_ms"] = \
                        neutral[0]
                if label == "A0" and op in epi_cycle:
                    for k in ("fused", "composed"):
                        epi_sum[k] = epi_sum.get(k, 0.0) + epi_cycle[op] * ms[k]

        for label, A, csr, op in epi_cases:
            for dtype, d in ((torch.float32, 1), (torch.float64, 3)):
                epilogue_case(label, A, csr, op, dtype, d)
        del epi_cases
        log(f"phase kernels: epilogue A0 per 1M V-cycle (2 first and 6 later "
            f"Chebyshev steps, 2 residuals), d=1 f32: fused "
            f"{epi_sum['fused']:.4f} ms, composed {epi_sum['composed']:.4f} ms")

        # The halo path's parts, 1M over 4 partitions on one rank, as phase
        # halo lays them out: the stacked A0 interior (SlicedDiag), the
        # stacked U0^T interior (SlicedEll) and the compact halo parts of
        # both, each against its plain version and cuSPARSE on the same
        # CSR; then the old stacked A0 ShuffleEll through shuffle_spmv (the
        # route they replaced).
        n1 = ctx.chain_csr[1].shape[0]
        nl0, P0 = partition_rows(n, 4)
        nl1, P1 = partition_rows(n1, 4)
        mesh4 = make_solver_mesh(4, "cuda")
        U0T_csr = ctx.U_csr[0].T.tocsr()
        t0 = time.perf_counter()
        pA0 = PartitionedOp(chain0, _halo_plan(chain0, 4, nl0, nl0), mesh4, P0, P0,
                            ctx.dtype, ctx.diag_min_groups)
        pU0T = PartitionedOp(U0T_csr, _halo_plan(U0T_csr, 4, nl1, nl0), mesh4, P0, P1,
                             ctx.dtype)
        log(f"phase kernels: halo path parts of A0 and U0^T over 4 partitions built in "
            f"{time.perf_counter() - t0:.2f} s")
        halo_cases = [("A0 interior", pA0, False), ("U0T interior", pU0T, False),
                      ("A0 halo part", pA0, True), ("U0T halo part", pU0T, True)]
        for label, pop, part in halo_cases:
            L = pop.Ah if part else pop.A
            inf, pinf = L.info(), pop.info()
            csr = layout_csr(L)
            lib = csr_tensor(csr, torch.float32, dev)
            nnz = csr.nnz
            diag = isinstance(L, SlicedDiag)
            kind = "halo_spmv" if part else ("sliced_diag_spmv" if diag else "sliced_spmv")
            nbytes = pinf["halo_bytes"] if part else pinf["interior_bytes"]
            log(f"phase kernels: halo {label}: {type(L).__name__} rows {L.nrows} cols "
                f"{L.ncols} nnz {nnz}, {inf['entries']} stored entries "
                f"({inf['entries'] / max(nnz, 1):.2f}x nnz), "
                + (f"{inf['wide_slices']} of {inf['slices']} slices wide, " if diag
                   else f"{L.tpr} threads per row, ")
                + f"{nbytes / 1e6:.3f} MB per f32 apply at d=1")
            for d in (1, 3):
                xs = rng.standard_normal((L.ncols,) if d == 1 else (L.ncols, d))
                x = torch.from_numpy(xs).to(dev, torch.float32)
                if part:
                    y0 = torch.from_numpy(rng.standard_normal(
                        (pop.A.nrows,) if d == 1 else (pop.A.nrows, d))).to(dev, torch.float32)
                    hargs = (L.slice_ptr, L.col, L.val, pop.out_row, x)
                    y_acc = y0.clone()        # the timed calls add into it
                    fns = {"new": lambda: hmod.halo_spmv(*hargs, y_acc, L.tpr),
                           "plain": lambda: hmod.halo_spmv_plain(*hargs, y_acc)}
                    y_new = hmod.halo_spmv(*hargs, y0.clone(), L.tpr)
                    y_ref = hmod.halo_spmv_plain(*hargs, y0.clone())
                    compact = slmod.sliced_spmv_plain(L.slice_ptr, L.col, L.val, x, L.nrows)
                elif diag:
                    dargs = (L.slice_ptr, L.base, L.delta, L.val, L.wide_ptr, L.wide_col, x)
                    fns = {"new": lambda: sdmod.sliced_diag_spmv(*dargs, L.nrows),
                           "plain": lambda: sdmod.sliced_diag_spmv_plain(*dargs, L.nrows)}
                    y_new, y_ref = fns["new"](), fns["plain"]()
                    compact = y_ref
                else:
                    fns = {"new": lambda: slmod.sliced_spmv(L.slice_ptr, L.col, L.val, x,
                                                            L.nrows, L.tpr),
                           "plain": lambda: slmod.sliced_spmv_plain(L.slice_ptr, L.col,
                                                                    L.val, x, L.nrows)}
                    y_new, y_ref = fns["new"](), fns["plain"]()
                    compact = y_ref
                fns["library"] = lambda: library_apply(lib, x)
                y_lib = fns["library"]()
                torch.cuda.synchronize()
                err, rel = rel_err(y_new, y_ref)
                _, rel_lib = rel_err(y_lib, compact)
                ok = rel <= TOL_F32 and rel_lib <= TOL_F32 and bool(torch.isfinite(y_new).all())
                ev, ms = time_in_turns(fns, ["new", "library", "plain", "library", "new"])
                if part:   # y read and written at its rows, out_row, real halo positions
                    bound = spmv_bound(nnz, L.nrows, pop.halo_real, d, 4,
                                       nnz * 8 + L.nrows * (4 + 4 * d))
                    bounds = [("", bound)]
                else:
                    neutral = spmv_bound(nnz, L.nrows, L.ncols, d, 4)
                    bound = neutral
                    bounds = [("format-neutral ", neutral)]
                    if diag:
                        ptr, wptr = L.slice_ptr.cpu().numpy(), L.wide_ptr.cpu().numpy()
                        bound = spmv_bound(nnz, L.nrows, L.ncols, d, 4,
                                           sliced_diag_bytes(ptr, wptr, 4))
                        bounds.insert(0, ("layout ", bound))
                log(f"phase kernels: {kind} halo {label} d={d} f32 device us: kernel "
                    f"{ms['new'] * 1e3:.2f}, library (cuSPARSE) {ms['library'] * 1e3:.2f}, "
                    f"plain {ms['plain'] * 1e3:.1f} (events per call: kernel "
                    f"{ev['new'] * 1e3:.2f}, library {ev['library'] * 1e3:.2f}); "
                    + "; ".join(f"{what}bound {b[0] * 1e3:.2f} us ({b[1]}), share kernel "
                                f"{b[0] / ms['new']:.3f} library {b[0] / ms['library']:.3f}"
                                for what, b in bounds)
                    + f"; max_abs_err {err:.3e} rel {rel:.3e}, library rel {rel_lib:.3e} "
                    f"(tol {TOL_F32}) {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"{kind} halo {label} d={d} disagrees")
                keep(kind, err, *((ms["new"], ms["plain"], bound, ms["library"])
                                  if part and d == 1 and label == "U0T halo part" else ()))
                del x, fns, y_new, y_ref, y_lib, compact
            # f64: the same layouts with values widened exactly
            x = torch.from_numpy(rng.standard_normal(L.ncols)).to(dev)
            v64 = L.val.double()
            if part:
                y0 = torch.from_numpy(rng.standard_normal(pop.A.nrows)).to(dev)
                hargs = (L.slice_ptr, L.col, v64, pop.out_row, x)
                _, rel = rel_err(hmod.halo_spmv(*hargs, y0.clone(), L.tpr),
                                 hmod.halo_spmv_plain(*hargs, y0.clone()))
            elif diag:
                dargs = (L.slice_ptr, L.base, L.delta, v64, L.wide_ptr, L.wide_col, x)
                _, rel = rel_err(sdmod.sliced_diag_spmv(*dargs, L.nrows),
                                 sdmod.sliced_diag_spmv_plain(*dargs, L.nrows))
            else:
                _, rel = rel_err(slmod.sliced_spmv(L.slice_ptr, L.col, v64, x, L.nrows, L.tpr),
                                 slmod.sliced_spmv_plain(L.slice_ptr, L.col, v64, x, L.nrows))
            log(f"phase kernels: {kind} halo {label} d=1 f64 rel {rel:.3e} (tol {TOL_F64})")
            if not rel <= TOL_F64:
                raise AssertionError(f"{kind} halo {label} f64 disagrees")
            del x, v64, lib, csr
        # The halo path's operations (1M over 4 partitions, as phase halo
        # runs them): a later and a first Chebyshev step and the residual of
        # the partitioned A0 (stacked interior SlicedDiag), the
        # prolongation's add of the partitioned U0 (SlicedEll); d = 1 f32
        # and d = 3 f64.  Each operation ("fused") is two launches, the
        # interior under its row mask and halo_spmv in the same mode, held
        # bitwise equal to the partitioned apply followed by the torch ops
        # ("composed"); each launch alone bitwise equal to its plain-mode
        # launch followed by the torch ops on its rows; all against the
        # plain versions within tolerance.  Timed in turns beside the bare
        # apply, the interior launch unmasked, halo_spmv in plain mode, the
        # plain versions and, for the residual and the add, cuSPARSE's
        # addmv/addmm on the whole partitioned operator's CSR (no single
        # PyTorch call computes a Chebyshev step).
        U0_csr = ctx.U_csr[0]
        pU0 = PartitionedOp(U0_csr, _halo_plan(U0_csr, 4, nl0, nl1), mesh4, P1, P0,
                            ctx.dtype)

        def stacked_csr(csr, nl_r, p_r, nl_c, p_c):
            """A global csr in the partitioned layout (global row r at
            (r // nl) * stride + r % nl; columns likewise), f32 values as
            the layouts hold them."""
            coo = csr.tocoo()
            return sp.csr_matrix(
                (coo.data.astype(np.float32),
                 ((coo.row // nl_r) * p_r + coo.row % nl_r,
                  (coo.col // nl_c) * p_c + coo.col % nl_c)),
                shape=(4 * p_r, 4 * p_c))

        def halo_epilogue_case(label, pop, whole, op, dtype, d):
            item = 4 if dtype == torch.float32 else 8
            tol = TOL_F32 if item == 4 else TOL_F64
            p = copy.copy(pop)            # the same partitions, values in dtype
            p.A = dataclasses.replace(pop.A, val=pop.A.val.to(dtype))
            p.Ah = dataclasses.replace(pop.Ah, val=pop.Ah.val.to(dtype))
            p._buffers = {}
            L, H, mask = p.A, p.Ah, p.row_mask
            n, hrows, o = L.nrows, H.nrows, p.out_row.long()
            diag = isinstance(L, SlicedDiag)
            iname = "sliced_diag_spmv" if diag else "sliced_spmv"
            hargs = (H.slice_ptr, H.col, H.val, p.out_row)

            def vec(rows, scale=1.0):
                v = scale * rng.standard_normal((rows,) if d == 1 else (rows, d))
                return torch.from_numpy(v).to(dev, dtype)

            def interior_plain(v):
                if diag:
                    return sdmod.sliced_diag_spmv_plain(
                        L.slice_ptr, L.base, L.delta, L.val, L.wide_ptr, L.wide_col, v,
                        n)
                return slmod.sliced_spmv_plain(L.slice_ptr, L.col, L.val, v, n)

            x = vec(L.ncols)
            first = op == "cheb_first"
            vb = n * d * item                   # one vector the shape of y
            if op in ("add", "residual"):
                mode = op
                v = vec(n)
                kw = {"b" if op == "residual" else "z": v}
                extra, extra_rows = vb, hrows * d * item
                W = csr_tensor(whole, dtype, dev)
                addm = torch.addmv if d == 1 else torch.addmm
                if op == "add":
                    fused = lambda: p.add(x, v)   # noqa: E731
                    interior = lambda m: sparse.spmv_add(L, x, v, m)   # noqa: E731
                    library = lambda: addm(v, W, x)   # noqa: E731
                else:
                    fused = lambda: p.residual(x, v)   # noqa: E731
                    interior = lambda m: sparse.spmv_residual(L, x, v, m)   # noqa: E731
                    library = lambda: addm(v, W, x, alpha=-1)   # noqa: E731

                def halo_mode(hb, y, dbuf):
                    fn = hmod.halo_spmv_add if op == "add" else hmod.halo_spmv_residual
                    return fn(*hargs, hb, y, v, H.tpr), None
            else:
                mode = "cheb"
                b, d_prev = vec(n), vec(n, 0.1)
                dinv = torch.from_numpy(0.5 + rng.random(n)).to(dev, dtype)
                c1 = None if first else EPI_C1
                kw = {"b": b, "dinv": dinv, "x": x, "d": None if first else d_prev,
                      "c1": c1, "c2": EPI_C2}
                # b, x, dinv read, d written (and read unless first)
                extra = 2 * vb + n * item + (0 if first else vb)
                extra_rows = hrows * (3 * d * item + item + (0 if first else d * item))
                d_work = d_prev.clone()          # the timed calls write it in place
                library = None
                fused = lambda: p.cheb(   # noqa: E731
                    dinv, b, x, None if first else d_work, c1, EPI_C2)
                interior = lambda m: sparse.cheb_step(   # noqa: E731
                    L, dinv, b, x, None if first else d_work, c1, EPI_C2, True, m)

                def halo_mode(hb, y, dbuf):
                    return hmod.halo_spmv_cheb(*hargs, hb, y, x, b, dinv, dbuf, c1,
                                               EPI_C2, H.tpr)

            def once():
                if mode != "cheb":
                    return (fused(),)
                return p.cheb(dinv, b, x, None if first else d_prev.clone(), c1, EPI_C2)

            def plain():
                out = epilogue_plain(mode, interior_plain(x), row_mask=mask, **kw)
                hb = p._exchange(x)()
                if mode == "cheb":
                    return hmod.halo_spmv_plain(*hargs, hb, out[0], "cheb", x=x, b=b,
                                                dinv=dinv, d=out[1], c1=c1, c2=EPI_C2)
                return (hmod.halo_spmv_plain(*hargs, hb, out, mode, **kw),)

            def tup(r):
                return r if isinstance(r, tuple) else (r,)

            # the whole operation against the composition and the plain versions
            got, composed, plain_v = once(), tup(epilogue_plain(mode, p(x), **kw)), plain()
            bitwise = all(torch.equal(g, c) for g, c in zip(got, composed))
            err, rel = rel_err(got[0], plain_v[0])
            lib_y = library() if library is not None else None
            lib_err = rel_err(lib_y, plain_v[0]) if lib_y is not None else None
            # each launch alone against its plain-mode launch and the torch ops
            m = masked_rows(mask, n)
            m = m[:, None] if d > 1 else m
            y_int = tup(interior(mask) if mode != "cheb" else sparse.cheb_step(
                L, dinv, b, x, None if first else d_prev.clone(), c1, EPI_C2, True, mask))
            ref_int = tup(epilogue_plain(mode, sparse.spmv(L, x), row_mask=mask, **kw))
            bit_int = torch.equal(y_int[0], ref_int[0]) and (
                mode != "cheb" or torch.equal(torch.where(m, ref_int[1], y_int[1]),
                                              ref_int[1]))
            hb = p._exchange(x)()
            y0 = y_int[0]
            d0 = ref_int[1] if mode == "cheb" else None   # y_int's, where it wrote
            y_h, d_h = halo_mode(hb, y0.clone(), None if d0 is None else d0.clone())
            ref_h = hmod.halo_spmv(*hargs, hb, y0.clone(), H.tpr)
            want = ref_h.clone()
            at = {k: (t.index_select(0, o) if isinstance(t, torch.Tensor) else t)
                  for k, t in kw.items()}
            if mode == "cheb":
                if first:
                    at["d"] = None
                want_x, want_d = epilogue_plain("cheb", ref_h[o], **at)
                want[o] = want_x
                bit_h = (torch.equal(y_h, want) and torch.equal(d_h[o], want_d)
                         and torch.equal(torch.where(m, d0, d_h), d0))
            else:
                want[o] = epilogue_plain(mode, ref_h[o], **at)
                bit_h = torch.equal(y_h, want)
            torch.cuda.synchronize()
            ok = (bitwise and bit_int and bit_h and rel <= tol
                  and bool(torch.isfinite(got[0]).all())
                  and (lib_err is None or lib_err[1] <= tol))
            y_work, y_add = y0.clone(), y0.clone()
            d_halo = None if d0 is None else d0.clone()
            fns = {"fused": fused, "composed": lambda: epilogue_plain(mode, p(x), **kw),
                   "apply": lambda: p(x), "interior": lambda: interior(mask),
                   "unmasked": lambda: interior(None),
                   "halo": lambda: halo_mode(hb, y_work, d_halo),
                   "halo_add": lambda: hmod.halo_spmv(*hargs, hb, y_add, H.tpr),
                   "plain": plain}
            order = ["fused", "composed", "apply", "interior", "unmasked", "halo",
                     "halo_add", "plain", "halo_add", "halo", "unmasked", "interior",
                     "apply", "composed", "fused"]
            if library is not None:
                fns["library"] = library
                order[8:8] = ["library"]
                order.append("library")
            ev, ms = time_in_turns(fns, order)
            interior_bytes = (sliced_diag_bytes(L.slice_ptr.cpu().numpy(),
                                                L.wide_ptr.cpu().numpy(), item) if diag
                              else sliced_bytes(L.slice_ptr.cpu().numpy(), item))
            halo_bytes = H.nnz * (4 + item) + hrows * 4
            nnz_all = whole.nnz
            bound = spmv_bound(nnz_all, n, L.ncols, d, item,
                               interior_bytes + halo_bytes + mask.numel() * 4 + extra)
            neutral = spmv_bound(nnz_all, n, L.ncols, d, item,
                                 nnz_all * (4 + item) + extra)
            bound_int = spmv_bound(L.nnz, n, L.ncols, d, item,
                                   interior_bytes + mask.numel() * 4 + extra)
            # the halo part: its entries, out_row, y read and written at its
            # rows, the real halo positions once, the epilogue's vectors there
            bound_h = spmv_bound(H.nnz, hrows, p.halo_real, d, item,
                                 H.nnz * (4 + item) + hrows * (4 + d * item) + extra_rows)
            lib_ms = ms.get("library")
            dt = "f32" if item == 4 else "f64"
            launches_us = (ms["interior"] + ms["halo"]) * 1e3
            log(f"phase kernels: halo epilogue {label} {op} d={d} {dt} (interior "
                f"{type(L).__name__} {iname}, halo part {hrows} rows {H.tpr} threads per "
                f"row) device us: fused {ms['fused'] * 1e3:.2f} (its two launches "
                f"{launches_us:.2f}: interior {ms['interior'] * 1e3:.2f}, halo_spmv "
                f"{mode} {ms['halo'] * 1e3:.2f}), composed (partitioned apply + torch "
                f"ops) {ms['composed'] * 1e3:.2f}, bare apply {ms['apply'] * 1e3:.2f}, "
                f"interior unmasked {ms['unmasked'] * 1e3:.2f}, halo_spmv plain mode "
                f"{ms['halo_add'] * 1e3:.2f}, "
                + (f"library (cuSPARSE addmv/addmm, whole operator) {lib_ms * 1e3:.2f}, "
                   if lib_ms is not None else "library none, ")
                + f"plain version {ms['plain'] * 1e3:.1f} (events per call: fused "
                f"{ev['fused'] * 1e3:.2f}, composed {ev['composed'] * 1e3:.2f}); bound "
                f"{bound[0] * 1e3:.2f} us ({bound[1]}; format-neutral "
                f"{neutral[0] * 1e3:.2f}), share fused {bound[0] / ms['fused']:.3f} "
                f"composed {bound[0] / ms['composed']:.3f}; interior bound "
                f"{bound_int[0] * 1e3:.2f} us share {bound_int[0] / ms['interior']:.3f}; "
                f"halo part bound {bound_h[0] * 1e3:.3f} us share "
                f"{bound_h[0] / ms['halo']:.3f}; max_abs_err {err:.3e} rel {rel:.3e} vs "
                f"plain (tol {tol})"
                + (f", library {lib_err[0]:.3e} rel {lib_err[1]:.3e}"
                   if lib_err is not None else "")
                + f"; bitwise: operation {bitwise}, interior {bit_int}, halo {bit_h} "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"halo epilogue {label} {op} d={d} {dt} disagrees")
            keep("halo_spmv", err)
            keep(iname, err)
            if (d, item) == (1, 4):
                kinfo["halo_spmv"]["epilogues"][f"{label} {op}"] = {
                    "ms": ms["halo"], "plain_mode_ms": ms["halo_add"],
                    "bound_ms": bound_h[0], "bound_by": bound_h[1], "library_ms": None,
                    "max_abs_err": err, "bitwise": bit_h,
                    "operation": {
                        "ms": ms["fused"], "launches_ms": launches_us / 1e3,
                        "composed_ms": ms["composed"], "apply_ms": ms["apply"],
                        "plain_ms": ms["plain"], "bound_ms": bound[0],
                        "bound_by": bound[1], "neutral_bound_ms": neutral[0],
                        "library_ms": lib_ms, "bitwise": bitwise}}
                kinfo[iname]["epilogues"][f"halo {label} {op} masked"] = {
                    "ms": ms["interior"], "unmasked_ms": ms["unmasked"],
                    "bound_ms": bound_int[0], "bound_by": bound_int[1],
                    "library_ms": None, "bitwise": bit_int}

        halo_epi = [("A0", pA0, stacked_csr(chain0, nl0, P0, nl0, P0), op)
                    for op in EPI_OPS]
        halo_epi.append(("U0", pU0, stacked_csr(U0_csr, nl0, P0, nl1, P1), "add"))
        for label, pop, whole, op in halo_epi:
            for dtype, d in ((torch.float32, 1), (torch.float64, 3)):
                halo_epilogue_case(label, pop, whole, op, dtype, d)
        # the loop's last bindings hold ~110 MiB of card memory (A0's f64
        # operands, U0^T's parts) that phase poisson's peak must not count
        del pA0, pU0T, pU0, halo_cases, halo_epi, L, pop, whole
        y0 = y_acc = hargs = dargs = None

        A = stacked_shuffle(_build_dist_op(chain0, 4, nl0, nl0, ctx.dtype), P0, P0, dev)
        nnz_h = int(torch.count_nonzero(A.v))
        hv = A.v.reshape(-1)
        keep_h = hv != 0
        hcols = (A.q.long()[:, :, None] * 128 + A.r.long()).reshape(-1)[keep_h]
        hrows = torch.arange(A.r.shape[1] * 128, device=dev).repeat(A.r.shape[0])[keep_h]
        lib = csr_tensor(sp.coo_matrix(
            (hv[keep_h].double().cpu().numpy(),
             (hrows.cpu().numpy(), hcols.cpu().numpy())), shape=(A.nrows, A.ncols)),
            torch.float32, dev)
        del hv, keep_h, hcols, hrows
        for d in (1, 3):
            xs = rng.standard_normal((A.ncols,) if d == 1 else (A.ncols, d))
            x = torch.from_numpy(xs).to(dev, torch.float32)
            y = smod.shuffle_spmv(A.q, A.r, A.v, x, A.nrows)
            ref = smod.shuffle_spmv_plain(A.q, A.r, A.v, x, A.nrows)
            err, rel = rel_err(y, ref)
            _, rel_lib = rel_err(library_apply(lib, x), ref)
            ok = rel <= TOL_F32 and rel_lib <= TOL_F32 and bool(torch.isfinite(y).all())
            _, ms = time_in_turns({
                "kernel": lambda: smod.shuffle_spmv(A.q, A.r, A.v, x, A.nrows),
                "library": lambda: library_apply(lib, x),
                "plain": lambda: smod.shuffle_spmv_plain(A.q, A.r, A.v, x, A.nrows),
            }, ["kernel", "library", "plain", "library", "kernel"])
            bound = spmv_bound(nnz_h, A.nrows, A.ncols, d, 4)
            log(f"phase kernels: shuffle_spmv old halo A0 interior, 4 partitions stacked "
                f"{tuple(A.r.shape)} d={d} f32 device us: kernel {ms['kernel'] * 1e3:.2f} "
                f"library (cuSPARSE) {ms['library'] * 1e3:.2f} "
                f"plain {ms['plain'] * 1e3:.1f}; bound {bound[0] * 1e3:.2f} us "
                f"({bound[1]}, {nnz_h} nonzeros), share kernel {bound[0] / ms['kernel']:.3f} "
                f"library {bound[0] / ms['library']:.3f}; max_abs_err {err:.3e} "
                f"rel {rel:.3e}, library rel {rel_lib:.3e} (tol {TOL_F32}) "
                f"{'ok' if ok else 'MISMATCH'}")
            if not ok:
                raise AssertionError(f"shuffle_spmv halo A0 d={d} disagrees")
            keep("shuffle_spmv", err)
            del x, y, ref
        del lib
        x = torch.from_numpy(rng.standard_normal(A.ncols)).to(dev)
        v64 = A.v.double()
        _, rel = rel_err(smod.shuffle_spmv(A.q, A.r, v64, x, A.nrows),
                         smod.shuffle_spmv_plain(A.q, A.r, v64, x, A.nrows))
        log(f"phase kernels: shuffle_spmv halo A0 d=1 f64 rel {rel:.3e} (tol {TOL_F64})")
        if not rel <= TOL_F64:
            raise AssertionError("shuffle_spmv halo A0 f64 disagrees")
        del x, v64, A, sliced_cases, sig21_U0T, t21
        torch.cuda.empty_cache()
        log(f"kernels: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("kernels", exc)

    # ---- 3. 10k smoothing solve ---------------------------------------------
    try:
        t_wall = time.perf_counter()
        V2, F2 = icosphere(5, bump=0.15)
        S2, M2 = cotan_laplacian(V2, F2), mass_voronoi(V2, F2)
        s2 = MultigridSolver(V2, neighbors_from_faces(F2), M2, lower_bound=300,
                             device="cuda")
        lhs2 = (M2 + 1e-3 * S2).tocsr()
        rhs2 = M2 @ V2
        counts.reset()
        x2 = s2.solve(lhs2, rhs2)
        launched = counts.read()
        res2 = s2.residual(lhs2, rhs2, x2)
        xd = s2.direct_solve(lhs2, rhs2)
        rel2 = float(np.linalg.norm(x2 - xd) / np.linalg.norm(xd))
        ok = (x2.shape == rhs2.shape and np.isfinite(x2).all()
              and res2 <= 1e-4 and rel2 <= 1e-3 and launched["sliced_spmv"] > 0
              and launched["shuffle_spmv"] == 0)
        log(f"phase smoothing: n={len(V2)} dof={s2.hierarchy.dof} "
            f"cycles {int(s2.solver_timing['iterations'])} residual {res2:.3e} "
            f"vs {s2.solver_timing['direct_backend']} rel {rel2:.3e} "
            f"launches {launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("10k smoothing solve failed its checks")
        log(f"smoothing: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("smoothing", exc)

    # ---- 4. the 1M Poisson solve (main path) ----------------------------------
    # mode="fused" is the main path: the cycle captured on the cold solve and
    # run under a conditional WHILE node, one graph launch and one host wait
    # per warm solve.  mode="traced" (the host loop) beside it.
    try:
        t_wall = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        counts.reset()
        t0 = time.perf_counter()
        x = solver.solve(lhs, rhs, mode="fused")
        cold_call = time.perf_counter() - t0
        launches = counts.read()
        launches_by_mode = counts.by_mode()
        ft = dict(solver.solver_timing)
        dispatched0 = ctx.dispatched
        cycles = int(ft["iterations"])
        cycles_ms = ft["cycles"]
        res = solver.residual(lhs, rhs, x)
        peak = torch.cuda.max_memory_allocated() / 2**20
        conv_fused = [r for _, r in solver.convergence]
        t0 = time.perf_counter()
        x_tr = solver.solve(lhs, rhs, mode="traced")
        traced_cold = (solver.solver_timing["cycles"], time.perf_counter() - t0)
        conv_traced = [r for _, r in solver.convergence]
        traced_dispatched = ctx.dispatched

        # warm solves, fused and traced in turns; CUDA events around each
        # WHILE-graph launch give the loop's device time
        warm = {"fused": [], "traced": []}
        warm_x = []
        with loop_events() as ev:
            for _ in range(5):
                for mode in warm:
                    t0 = time.perf_counter()
                    xw = solver.solve(lhs, rhs, mode=mode)
                    t = solver.solver_timing
                    warm[mode].append((t["cycles"], time.perf_counter() - t0,
                                       ctx.dispatched, int(t.get("host_reads", 0)),
                                       int(t.get("graph_launches", 0))))
                    if mode == "fused":
                        warm_x.append(xw)
        loop_dev_ms = [a.elapsed_time(b) for a, b in ev]
        (loop,) = ctx._fused.values()
        graph = loop.graph
        # The same captured body replayed 5 times from the host, back to back
        # and with a host read of the stop flag after each replay (the loop
        # before the WHILE node), in turns: the device ms of each (CUDA
        # events) and its wall ms, beside the WHILE graph's.  The body's
        # buffers hold the last solve; 5 more cycles change nothing they are
        # read for, and the next solve resets them.  These replays bypass
        # the wrappers' launch counts.
        graph.graph.instantiate()
        replays = {"back to back": [], "a host read each": []}
        for _ in range(3):
            for how, runs in replays.items():
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                e0.record()
                for _ in range(cycles):
                    graph.graph.replay()
                    if how == "a host read each":
                        bool(loop.state.more)
                e1.record()
                torch.cuda.synchronize()
                runs.append((e0.elapsed_time(e1), (time.perf_counter() - t0) * 1000))
        with torch_trace(trace_dir, name="poisson_fused_warm_solve") as prof:
            solver.solve(lhs, rhs, mode="fused")
        fused_traced_ms = solver.solver_timing["cycles"]
        dispatched = ctx.dispatched
        fused_msg = trace_summary(prof, "poisson_fused_warm_solve", dispatched)
        fused_sdiag_events = spmv_events(prof, "sliced_diag_spmv")
        with torch_trace(trace_dir, name="poisson_traced_warm_solve") as prof:
            solver.solve(lhs, rhs, mode="traced")
        host_traced_ms = solver.solver_timing["cycles"]
        host_dispatched = ctx.dispatched
        host_msg = trace_summary(prof, "poisson_traced_warm_solve", host_dispatched)

        # The same solve with the plain compositions patched in (each
        # operation as the kernel's plain SpMV and the torch ops, the
        # epilogues' bitwise reference), captured on a cold solve into a
        # graph pool of its own; then warm solves of the two WHILE graphs in
        # turns (E P P E ...), CUDA events around each launch.
        epi_loops, epi_pool = ctx._fused, ctx._graph_pool
        ctx._fused, ctx._graph_pool = {}, None
        with plain_compositions():
            x_plain = solver.solve(lhs, rhs, mode="fused")
        conv_plain = [r for _, r in solver.convergence]
        cycles_plain = int(solver.solver_timing["iterations"])
        plain_loops = ctx._fused
        (ploop,) = plain_loops.values()
        turns = {"epilogues": [], "plain": []}
        turn_x = []
        with loop_events() as ev:
            for order in (("epilogues", "plain"), ("plain", "epilogues")) * 3:
                for how in order:
                    ctx._fused = epi_loops if how == "epilogues" else plain_loops
                    turn_x.append(solver.solve(lhs, rhs, mode="fused"))
                    turns[how].append(solver.solver_timing["cycles"])
        turn_dev = {"epilogues": [], "plain": []}
        for (a, b), how in zip(ev, [h for o in (("epilogues", "plain"),
                                                ("plain", "epilogues")) * 3 for h in o]):
            turn_dev[how].append(a.elapsed_time(b))
        ctx._fused = plain_loops
        with torch_trace(trace_dir, name="poisson_plain_fused_warm_solve") as prof:
            solver.solve(lhs, rhs, mode="fused")
        plain_msg = trace_summary(prof, "poisson_plain_fused_warm_solve", ctx.dispatched)
        release_loops(plain_loops, dev)
        ctx._fused, ctx._graph_pool = epi_loops, epi_pool

        def median(v):
            return sorted(v)[len(v) // 2]

        step_nodes = sum(graph.step_nodes.values())
        checks = {
            "finite, shape": bool(np.isfinite(x).all()) and x.shape == rhs.shape,
            "residual <= 1e-4": res <= 1e-4,
            "5 cycles": cycles == 5,
            "fused x == traced x (bitwise)": np.array_equal(x, x_tr),
            "fused trace == traced trace": conv_fused == conv_traced,
            "warm fused x == traced x (bitwise)":
                all(np.array_equal(xw, x_tr) for xw in warm_x),
            "cold: 2 host reads, 1 graph launch":
                (int(ft["host_reads"]), int(ft["graph_launches"])) == (2, 1),
            "warm: 1 host read, 1 graph launch, 5 cycles run":
                all(r[2:] == (5, 1, 1) for r in warm["fused"]),
            "one capture, one WHILE graph over all fused solves":
                (graph.captures, graph.builds) == (1, 1)
                and graph.launches == 2 + len(warm["fused"]) + len(turns["epilogues"]),
            "sliced_diag_spmv == 10 x cycles run":
                launches["sliced_diag_spmv"] == 10 * dispatched0,
            "sliced_spmv launched": launches["sliced_spmv"] > 0,
            "no diag_spmv, shuffle_spmv":
                launches["diag_spmv"] == 0 and launches["shuffle_spmv"] == 0,
            "every epilogue launched (A0 cheb, residual; sliced cheb, residual, "
            "add, plain)":
                all(launches_by_mode["sliced_diag_spmv"][m] > 0
                    for m in ("cheb", "residual"))
                and all(launches_by_mode["sliced_spmv"][m] > 0
                        for m in ("cheb", "residual", "add", "plain")),
            "captured cycle <= 80 kernels": graph.step_nodes.get("kernel", 0) <= 80,
            "plain compositions: x, trace, cycles (bitwise)":
                np.array_equal(x_plain, x) and conv_plain == conv_fused
                and cycles_plain == cycles
                and all(np.array_equal(xt, x) for xt in turn_x),
            "warm fused with epilogues no slower than with the plain compositions":
                median(turns["epilogues"]) <= median(turns["plain"]),
        }
        ok = all(checks.values())
        # the loop-control kernel runs once before the WHILE node and once
        # at the end of every body
        loop_info.update(
            launches=graph.launches + graph.bodies, graph_launches=graph.launches,
            bodies=graph.bodies, step_nodes=graph.step_nodes,
            outer_nodes=step_nodes + 4, build_ms=graph.build_ms,
            capture_ms=graph.capture_ms,
            warm_solve_ms=sorted(w for w, *_ in warm["fused"])[len(warm["fused"]) // 2],
            device_ms=sorted(loop_dev_ms)[len(loop_dev_ms) // 2],
            plain_compositions={"step_nodes": ploop.graph.step_nodes,
                                "warm_solve_ms": median(turns["plain"]),
                                "device_ms": median(turn_dev["plain"])})
        log(f"phase poisson: dof={solver.hierarchy.dof} {layouts(ctx)} "
            f"cycles {cycles} residual(host f64) {res:.3e} "
            f"trace {[f'{r:.3e}' for r in conv_fused]}")
        log(f"phase poisson: WHILE graph: {step_nodes + 4} nodes (the captured cycle's "
            f"{step_nodes}: {graph.step_nodes}; a control kernel, the WHILE node, "
            f"the body's child graph and control kernel), built in "
            f"{ft['graph_build_ms']:.2f} ms (graph_build_ms) after a capture of "
            f"{ft['graph_capture_ms']:.1f} ms")
        log(f"phase poisson: hierarchy {t_hier:.2f} s setup {t_setup:.2f} s; fused cold "
            f"solve: cycles {cycles_ms:.2f} ms (call {cold_call:.3f} s), {dispatched0} "
            f"cycles run, {int(ft['host_reads'])} host reads, "
            f"{int(ft['graph_launches'])} graph launch, graph pool "
            f"{ft['graph_pool_mib']:.1f} MiB (d=1 f32); traced cold solve "
            f"{traced_cold[0]:.2f} ms (call {traced_cold[1]:.3f} s, {traced_dispatched} "
            f"dispatched); peak device memory {peak:.0f} MiB, {peak - mq_mib:.0f} MiB "
            f"without MinQuad's context ({mq_mib:.0f} MiB, resident since poisson-setup)")
        for mode, runs in warm.items():
            ms = sorted(w for w, *_ in runs)
            log(f"phase poisson: warm {mode}: cycles ms " + ", ".join(
                f"{w:.3f}" for w, *_ in runs) + f" (median {ms[len(ms) // 2]:.3f}, "
                f"{ms[len(ms) // 2] / max(cycles, 1):.3f} ms/cycle); calls s "
                + ", ".join(f"{c:.4f}" for _, c, *_ in runs)
                + f"; cycles run {[r[2] for r in runs]}"
                + (f" host reads {[r[3] for r in runs]} graph launches "
                   f"{[r[4] for r in runs]}" if mode == "fused" else ""))
        log(f"phase poisson: WHILE graph device ms per warm fused solve (CUDA events "
            f"around its launch): " + ", ".join(f"{m:.4f}" for m in loop_dev_ms)
            + f" (median {sorted(loop_dev_ms)[len(loop_dev_ms) // 2]:.4f}, "
            f"{sorted(loop_dev_ms)[len(loop_dev_ms) // 2] / max(cycles, 1):.4f} ms per "
            f"cycle)")
        log(f"phase poisson: the captured body replayed {cycles} times from the host "
            f"(the loop without a WHILE node), device / wall ms: " + "; ".join(
                f"{how} " + ", ".join(f"{d:.4f} / {w:.4f}" for d, w in runs)
                for how, runs in replays.items()))
        log(f"phase poisson: fused warm solve under the profiler {fused_traced_ms:.2f} ms, "
            f"{dispatched} cycles run for {cycles} (1 graph launch; the trace holds "
            f"{fused_sdiag_events} sliced_diag_spmv events for the {10 * dispatched} "
            f"the card ran, and the per-cycle figures below divide what it holds by "
            f"{dispatched}): {fused_msg}")
        log(f"phase poisson: traced warm solve under the profiler {host_traced_ms:.2f} ms, "
            f"{host_dispatched} cycles dispatched for {cycles}: {host_msg}")
        log(f"phase poisson: epilogues against the plain compositions (each SpMV "
            f"followed by its torch ops), same run: captured cycle kernels "
            f"{graph.step_nodes.get('kernel', 0)} against "
            f"{ploop.graph.step_nodes.get('kernel', 0)}, WHILE graph nodes "
            f"{step_nodes + 4} against {sum(ploop.graph.step_nodes.values()) + 4}; "
            f"warm fused cycles ms in turns epilogues "
            + ", ".join(f"{v:.3f}" for v in turns["epilogues"])
            + f" (median {median(turns['epilogues']):.3f}), plain "
            + ", ".join(f"{v:.3f}" for v in turns["plain"])
            + f" (median {median(turns['plain']):.3f}); WHILE graph device ms "
            f"epilogues " + ", ".join(f"{v:.4f}" for v in turn_dev["epilogues"])
            + f" (median {median(turn_dev['epilogues']):.4f}, "
            f"{median(turn_dev['epilogues']) / max(cycles, 1):.4f} a cycle), plain "
            + ", ".join(f"{v:.4f}" for v in turn_dev["plain"])
            + f" (median {median(turn_dev['plain']):.4f}, "
            f"{median(turn_dev['plain']) / max(cycles, 1):.4f} a cycle); cycles "
            f"{cycles} / {cycles_plain}, x, trace bitwise equal "
            f"{np.array_equal(x_plain, x) and conv_plain == conv_fused}")
        log(f"phase poisson: plain-composition fused warm solve under the profiler: "
            f"{plain_msg}")
        log(f"phase poisson: launches by epilogue {launches_by_mode} (cold fused solve)")
        log(f"phase poisson: launches {launches} (sliced_diag_spmv expected 10 per "
            f"cycle run, {dispatched0} run) checks "
            f"{[k for k, v in checks.items() if not v] or 'all passed'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("1M Poisson solve failed its checks")
        x_single, cycles_single = x, cycles
        log(f"poisson: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("poisson", exc)

    # ---- halo: the 1M Poisson solve over 4 row partitions -------------------
    halo_dir = tempfile.mkdtemp(prefix="gravo_halo_")
    atexit.register(shutil.rmtree, halo_dir, True)
    try:
        t_wall = time.perf_counter()
        import torch.distributed as dist
        from gravo_mg_tpu_torch.parallel import multihost
        from gravo_mg_tpu_torch.parallel.halo import HaloContext

        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")   # no network
        multihost.initialize(
            init_method=f"file://{os.path.join(halo_dir, 'rendezvous')}",
            world_size=1, rank=0, backend="nccl")
        hmesh = multihost.global_row_mesh(4, "cuda")
        t0 = time.perf_counter()
        hctx = HaloContext(ctx, hmesh)
        torch.cuda.synchronize()
        t_hbuild = time.perf_counter() - t0
        log(f"phase halo: backend {dist.get_backend()} world "
            f"{dist.get_world_size()} partitions {hmesh.n_partitions}")
        plan = hctx.plan_info()
        # applies per halo cycle (d = 1): each level's A in the smoother
        # sweeps and its residual, A0 once more and M once in the
        # criterion-2 residual check, each transfer once
        parts = [(f"level {k} {p}", lv[p], 9 + (k == 0) if p == "A" else 1)
                 for k, lv in enumerate(plan) for p in ("A", "U", "UT")]
        parts.append(("M", hctx.M.info(), 1))
        for label, info, _ in parts:
            log(f"phase halo: {label}: halo {info['halo']} shifts {info['shifts']}; "
                f"interior {info['interior']} {info['interior_entries']} entries "
                f"{info['interior_bytes'] / 1e6:.3f} MB per apply; halo part "
                f"{info['halo_rows']} rows, {info['halo_nnz']} nnz in "
                f"{info['halo_entries']} entries, {info['halo_bytes'] / 1e3:.1f} kB per apply")
        halo_mb = sum(w * info["halo_bytes"] for _, info, w in parts) / 1e6
        inner_mb = sum(w * info["interior_bytes"] for _, info, w in parts) / 1e6
        log(f"phase halo: per cycle at d=1 ({sum(w for *_, w in parts)} partitioned "
            f"applies): halo parts {halo_mb:.3f} MB, interiors {inner_mb:.1f} MB; "
            f"nloc per level {[lv['nloc'] for lv in plan]}")
        kw = HALO_KW
        # The main path: mode="fused", one halo cycle (its NCCL all-gather
        # and all-reduce included) captured on the cold solve and run under
        # a conditional WHILE node.  mode="traced" (the host loop) beside it.
        counts.reset()
        t0 = time.perf_counter()
        xh, hcycles, hres_dev = hctx.solve(rhs, **kw)
        cold_s = time.perf_counter() - t0
        launches = counts.read()
        hmodes = counts.by_mode()
        ht = dict(hctx.timing)
        hrun0 = hctx.dispatched
        t0 = time.perf_counter()
        xh_tr, hcycles_tr, hres_tr = hctx.solve(rhs, mode="traced", **kw)
        traced_cold = (hctx.timing["cycles_ms"], time.perf_counter() - t0)
        warm = {"fused": [], "traced": []}
        with loop_events() as ev:
            for _ in range(5):
                for mode in ("fused", "traced"):
                    t0 = time.perf_counter()
                    hctx.solve(rhs, mode=mode, **kw)
                    warm[mode].append((hctx.timing["cycles_ms"],
                                       time.perf_counter() - t0, hctx.dispatched,
                                       int(hctx.timing.get("host_reads", 0)),
                                       int(hctx.timing.get("graph_launches", 0))))
        hloop_dev_ms = [a.elapsed_time(b) for a, b in ev]
        (hloop,) = hctx._fused.values()
        hgraph = hloop.graph
        htrace = hloop.state.trace[:hcycles].tolist()   # the last fused solve's

        # The same solve with the plain compositions patched in (each
        # operation the partitioned apply followed by its torch ops, the
        # epilogues' bitwise reference), captured on a cold solve into a
        # graph pool of its own; then warm solves of the two WHILE graphs in
        # turns (E P P E ...), CUDA events around each launch.
        epi_loops, epi_pool = hctx._fused, hctx._graph_pool
        hctx._fused, hctx._graph_pool = {}, None
        with plain_compositions():
            xh_plain, hcycles_plain, hres_plain = hctx.solve(rhs, **kw)
        plain_loops = hctx._fused
        (hploop,) = plain_loops.values()
        htrace_plain = hploop.state.trace[:hcycles_plain].tolist()
        hturns = {"epilogues": [], "plain": []}
        hturn_x = []
        with loop_events() as ev:
            for order in (("epilogues", "plain"), ("plain", "epilogues")) * 3:
                for how in order:
                    hctx._fused = epi_loops if how == "epilogues" else plain_loops
                    xt, it_t, res_t = hctx.solve(rhs, **kw)
                    hturn_x.append(np.array_equal(xt, xh) and (it_t, res_t)
                                   == (hcycles, hres_dev))
                    hturns[how].append(hctx.timing["cycles_ms"])
        hturn_dev = {"epilogues": [], "plain": []}
        for (a, b), how in zip(ev, [h for o in (("epilogues", "plain"),
                                                ("plain", "epilogues")) * 3 for h in o]):
            hturn_dev[how].append(a.elapsed_time(b))
        hctx._fused = plain_loops
        with torch_trace(halo_dir, name="halo_plain_fused_warm_solve") as prof:
            hctx.solve(rhs, **kw)
        hplain_msg = trace_summary(prof, "halo_plain_fused_warm_solve", hctx.dispatched)
        hplain_nodes = dict(hploop.graph.step_nodes)
        release_loops(plain_loops, dev)
        hctx._fused, hctx._graph_pool = epi_loops, epi_pool
        del hploop

        def median(v):
            return sorted(v)[len(v) // 2]

        hres = solver.residual(lhs, rhs, xh)
        rel = float(np.abs(xh - x_single).max() / np.abs(x_single).max())
        # The same without the deflated constant, which dominates max|x|:
        # a solve that returned only the constant would still pass `rel`.
        xs0, xh0 = x_single - x_single.mean(), xh - xh.mean()
        rel0 = float(np.abs(xh0 - xs0).max() / np.abs(xs0).max())
        with torch_trace(halo_dir, name="halo_fused_warm_solve") as prof:
            hctx.solve(rhs, **kw)
        fused_prof_ms = hctx.timing["cycles_ms"]
        fused_msg = trace_summary(prof, "halo_fused_warm_solve", hctx.dispatched)
        fused_halo_events = spmv_events(prof, "halo_spmv")
        with torch_trace(halo_dir, name="halo_warm_solve") as prof:
            hctx.solve(rhs, mode="traced", **kw)
        traced_ms = hctx.timing["cycles_ms"]
        trace_msg = trace_summary(prof, "halo_warm_solve", hcycles_tr)
        halo0 = plan[0]["A"]["halo"]
        checks = {
            "residual <= 1e-4": hres <= 1e-4,
            "cycles within 1 of poisson": abs(hcycles - cycles_single) <= 1,
            "rel diff < 1e-4": rel < 1e-4,
            "mean-free rel diff < 1e-3": rel0 < 1e-3,
            "fused x == traced x (bitwise)": np.array_equal(xh, xh_tr),
            "fused cycles, res == traced": (hcycles, hres_dev) == (hcycles_tr, hres_tr),
            "5 cycles": hcycles == 5,
            "plain compositions: x, trace, cycles, res (bitwise)":
                np.array_equal(xh_plain, xh) and htrace_plain == htrace
                and (hcycles_plain, hres_plain) == (hcycles, hres_dev) and all(hturn_x),
            "every halo_spmv epilogue launched (residual, add, cheb)":
                all(hmodes["halo_spmv"][m] > 0 for m in ("residual", "add", "cheb")),
            "captured halo cycle <= 230 kernels": hgraph.step_nodes.get("kernel", 0) <= 230,
            "cold: 2 host reads, 1 graph launch":
                (int(ht["host_reads"]), int(ht["graph_launches"])) == (2, 1),
            "warm: 1 host read, 1 graph launch":
                all(r[3:] == (1, 1) and r[2] == hcycles for r in warm["fused"]),
            "one capture, one WHILE graph over all fused solves":
                (hgraph.captures, hgraph.builds) == (1, 1),
            "sliced_diag_spmv == 10 x cycles run":
                launches["sliced_diag_spmv"] == 10 * hrun0,
            "level-0 halo < 5% of nloc": halo0 < 0.05 * plan[0]["nloc"],
            "A0 interior SlicedDiag": plan[0]["A"]["interior"] == "SlicedDiag",
            "halo_spmv launched": launches["halo_spmv"] > 0,
            "sliced_spmv launched": launches["sliced_spmv"] > 0,
            "no shuffle_spmv": launches["shuffle_spmv"] == 0,
            "no diag_spmv": launches["diag_spmv"] == 0,
            "finite": bool(np.isfinite(xh).all()) and xh.shape == rhs.shape,
        }
        ok = all(checks.values())
        log(f"phase halo: partitions {hmesh.n_partitions} on 1 NCCL rank, "
            f"partition build {t_hbuild:.2f} s, cycles {hcycles} (poisson "
            f"{cycles_single}) residual(host f64) {hres:.3e} device {hres_dev:.3e} "
            f"max|x_halo - x_single|/max|x_single| {rel:.3e} (mean-free parts "
            f"{rel0:.3e})")
        log(f"phase halo: fused cold solve cycles {ht['cycles_ms']:.2f} ms (call "
            f"{cold_s:.3f} s), {hrun0} cycles run, host_reads {int(ht['host_reads'])} "
            f"graph_launches {int(ht['graph_launches'])} graph_captures "
            f"{int(ht['graph_captures'])}, capture {ht['graph_capture_ms']:.1f} ms, "
            f"WHILE graph of {sum(hgraph.step_nodes.values()) + 4} nodes "
            f"({hgraph.step_nodes} in the cycle) built in {ht['graph_build_ms']:.2f} ms, "
            f"graph pool {ht['graph_pool_mib']:.1f} MiB (d=1 f32); traced cold solve "
            f"{traced_cold[0]:.2f} ms (call {traced_cold[1]:.3f} s)")
        for mode, runs in warm.items():
            ms = sorted(w for w, *_ in runs)
            log(f"phase halo: warm {mode}: cycles ms " + ", ".join(
                f"{w:.3f}" for w, *_ in runs) + f" (median {ms[len(ms) // 2]:.3f}, "
                f"{ms[len(ms) // 2] / max(hcycles, 1):.3f} ms/cycle); calls s "
                + ", ".join(f"{c:.4f}" for _, c, *_ in runs)
                + f"; cycles run {[r[2] for r in runs]}"
                + (f" host reads {[r[3] for r in runs]} graph launches "
                   f"{[r[4] for r in runs]}" if mode == "fused" else ""))
        hmed = sorted(hloop_dev_ms)[len(hloop_dev_ms) // 2]
        log(f"phase halo: WHILE graph device ms per warm fused solve (CUDA events "
            f"around its launch): " + ", ".join(f"{m:.4f}" for m in hloop_dev_ms)
            + f" (median {hmed:.4f}, {hmed / max(hcycles, 1):.4f} ms per cycle)")
        log(f"phase halo: fused warm solve under the profiler {fused_prof_ms:.2f} ms "
            f"(the trace holds {fused_halo_events} halo_spmv events for the "
            f"{launches['halo_spmv'] // max(hrun0, 1) * hcycles} the card ran): "
            f"{fused_msg}")
        log(f"phase halo: traced warm solve under the profiler {traced_ms:.2f} ms: "
            f"{trace_msg}")
        log(f"phase halo: epilogues against the plain compositions (each operation "
            f"the partitioned apply followed by its torch ops), same run: captured "
            f"cycle kernels {hgraph.step_nodes.get('kernel', 0)} against "
            f"{hplain_nodes.get('kernel', 0)}, WHILE graph nodes "
            f"{sum(hgraph.step_nodes.values()) + 4} against "
            f"{sum(hplain_nodes.values()) + 4}; warm fused cycles ms in turns epilogues "
            + ", ".join(f"{v:.3f}" for v in hturns["epilogues"])
            + f" (median {median(hturns['epilogues']):.3f}), plain "
            + ", ".join(f"{v:.3f}" for v in hturns["plain"])
            + f" (median {median(hturns['plain']):.3f}); WHILE graph device ms "
            f"epilogues " + ", ".join(f"{v:.4f}" for v in hturn_dev["epilogues"])
            + f" (median {median(hturn_dev['epilogues']):.4f}, "
            f"{median(hturn_dev['epilogues']) / max(hcycles, 1):.4f} a cycle), plain "
            + ", ".join(f"{v:.4f}" for v in hturn_dev["plain"])
            + f" (median {median(hturn_dev['plain']):.4f}, "
            f"{median(hturn_dev['plain']) / max(hcycles, 1):.4f} a cycle); cycles "
            f"{hcycles} / {hcycles_plain}, x, trace, residual bitwise equal "
            f"{np.array_equal(xh_plain, xh) and htrace_plain == htrace}")
        log(f"phase halo: plain-composition fused warm solve under the profiler: "
            f"{hplain_msg}")
        log(f"phase halo: launches by epilogue {hmodes} (fused cold solve)")
        log(f"phase halo: launches {launches} (fused cold solve; sliced_diag_spmv "
            f"expected 10 per cycle run, {hrun0} run) checks "
            f"{[k for k, v in checks.items() if not v] or 'all passed'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("1M halo solve failed its checks")
        dist.destroy_process_group()
        del hctx, xh, xh_tr
        torch.cuda.empty_cache()
        log(f"halo: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("halo", exc)

    # ---- halo-multigpu: the same system, one NCCL rank per GPU ---------------
    try:
        t_wall = time.perf_counter()
        if not multigpu_phase(halo_dir, cycles_single):
            raise AssertionError("the multi-GPU halo solve failed its checks")
        log(f"halo-multigpu: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("halo-multigpu", exc)

    # ---- 5. device CG on the 1M torus ---------------------------------------
    try:
        t_wall = time.perf_counter()
        rhs_cg = M @ np.random.default_rng(42).standard_normal(n)
        counts.reset()
        t0 = time.perf_counter()
        x = solver.cg_solve(lhs_cg, rhs_cg, max_iter=2000)
        wall = time.perf_counter() - t0
        launched = counts.read()
        t = dict(solver.solver_timing)
        res = rel_residual_f64(lhs_cg, x.astype(np.float64), rhs_cg)
        # warm calls: the facade keeps the captured unit, so every unit is a
        # replay; beside them the loop with its units run eagerly (the loop
        # before the graph), in the same process
        warm, eager = [], []
        for _ in range(3):
            x_w = solver.cg_solve(lhs_cg, rhs_cg, max_iter=2000)
            warm.append((solver.solver_timing["cg_ms"],
                         int(solver.solver_timing["cg_graph_replays"])))

        class EagerUnit(StepGraph):
            def run(self, n):
                for _ in range(n):
                    self.step()

        cg_direct.StepGraph = EagerUnit
        try:
            for _ in range(3):
                te = {}
                x_e = cg_direct.cg_solve(lhs_cg, rhs_cg, tol=solver.tolerance,
                                         max_iter=2000, device=dev, timing=te)
                eager.append(te["cg_ms"])
        finally:
            cg_direct.StepGraph = StepGraph
        # 32 iterations a unit: the first call's first eager, the rest replays
        replays = int(t["cg_graph_replays"])
        units = int(t["cg_iterations"]) // 32
        ok = (x.shape == rhs_cg.shape and np.isfinite(x).all() and res <= 1e-4
              and int(t["cg_iterations"]) == 128 and replays == units - 1
              and all(r == units for _, r in warm)
              and np.array_equal(x_w, x) and np.array_equal(x_e, x)
              and launched["sliced_diag_spmv"] > 0)
        log(f"phase cg: n={n} operator {type(A_cg).__name__} "
            f"iterations {int(t['cg_iterations'])} cold loop {t['cg_ms']:.2f} ms "
            f"(unit capture {t['cg_capture_ms']:.1f} ms; call with operator build "
            f"and upload {wall:.2f} s), graph replays {replays}; warm loops "
            f"{', '.join(f'{w:.2f}' for w, _ in warm)} ms ({warm[0][1]} replays each); "
            f"eager units (the loop before the graph) {', '.join(f'{e:.2f}' for e in eager)} "
            f"ms; x equal across all {np.array_equal(x_w, x) and np.array_equal(x_e, x)}; "
            f"residual(host f64) {res:.3e} device "
            f"{t['cg_residual']:.3e} launches {launched} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("1M CG solve failed its checks")
        log(f"cg: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("cg", exc)

    # ---- 6. MinQuadWithFixedMG on the 1M solver ------------------------------
    try:
        t_wall = time.perf_counter()
        counts.reset()
        x, iters, res_dev, _ = mq.solve(B, Y)
        traced_ms = mq.ctx.timing["cycles"]
        fused = []
        for _ in range(2):          # cold (captures the reduced cycle), warm
            xf, iters_f, _, _ = mq.solve(B, Y, mode="fused")
            t = mq.ctx.timing
            fused.append((t["cycles"], mq.ctx.dispatched, int(t["host_reads"]),
                          int(t["graph_launches"])))
            same_f = bool(np.array_equal(xf, x)) and iters_f == iters
        mq_graph = dict(mq.ctx.timing)
        (mq_loop,) = mq.ctx._fused.values()
        launched = counts.read()
        u = mq.unknown
        r = mq.A_uu @ x[u] - (B[u] - mq.A_uk @ Y)
        Muu = M[u][:, u]
        b_u = B[u] - mq.A_uk @ Y
        res = float(np.sqrt((r @ (Muu @ r)) / (b_u @ (Muu @ b_u))))
        same = bool(np.array_equal(xf, x)) and iters_f == iters and same_f
        loop_ok = ([f[2:] for f in fused] == [(2, 1), (1, 1)]
                   and (mq_loop.graph.captures, mq_loop.graph.builds) == (1, 1))
        ok = (np.isfinite(x).all() and np.array_equal(x[known], Y)
              and res <= 1e-4 and launched["sliced_spmv"] > 0 and same and loop_ok
              and launched["sliced_diag_spmv"] > 0 and launched["diag_spmv"] == 0)
        log(f"phase minquad: n={n} known {known.size} dof={mq.ctx.hierarchy.dof} "
            f"{layouts(mq.ctx)} precompute {t_pre:.2f} s cycles {iters} traced "
            f"{traced_ms:.2f} ms, fused cold / warm "
            f"{fused[0][0]:.2f} / {fused[1][0]:.2f} ms ({fused[1][1]} cycles run, host "
            f"reads / graph launches {[f[2:] for f in fused]}, one capture and one "
            f"WHILE graph {loop_ok}, built in {mq_graph['graph_build_ms']:.2f} ms, "
            f"graph pool {mq_graph['graph_pool_mib']:.1f} MiB), fused x == traced x "
            f"{same}; residual(host f64, reduced, "
            f"criterion 2) {res:.3e} device {res_dev:.3e} x[known]==Y "
            f"{bool(np.array_equal(x[known], Y))} launches {launched} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("1M MinQuad solve failed its checks")
        del mq
        log(f"minquad: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("minquad", exc)

    # ---- 7. ConformalFlow on the 1M torus ------------------------------------
    # In f64: on the area-normalized 1M torus, M ~ 1e-6 against tau S ~ 4e-3,
    # so f32 cannot represent a solution whose residual is below ~3.5e-4
    # (the residual floor grows with n; 1.05e-4 at 262k).
    try:
        t_wall = time.perf_counter()
        t0 = time.perf_counter()
        flow = ConformalFlow(
            V, F, tau=1e-3,
            solver_factory=lambda P, nb, Mp: MultigridSolver(
                P, nb, Mp, device="cuda", dtype=torch.float64),
        )
        log(f"phase flow: n={n} f64 operators+hierarchy "
            f"{time.perf_counter() - t0:.2f} s dof={flow.solver.hierarchy.dof}")
        fs = flow.solver
        seen = {}
        plain_solve = fs.solve

        def recording_solve(lhs_t, rhs_t, *args, **kw):
            t = time.perf_counter()
            fs._context(lhs_t)      # new context, or update_lhs of the same one
            torch.cuda.synchronize()
            seen["context_s"] = time.perf_counter() - t
            x_t = plain_solve(lhs_t, rhs_t, *args, **kw)
            seen["traced"] = dict(fs.solver_timing)
            # the same system in mode="fused" on the context update_lhs has
            # just refreshed: its graph is captured and built anew (cold),
            # then once more (warm)
            x_f = plain_solve(lhs_t, rhs_t, *args, **{**kw, "mode": "fused"})
            seen["fused"] = dict(fs.solver_timing)
            x_w = plain_solve(lhs_t, rhs_t, *args, **{**kw, "mode": "fused"})
            seen["warm"] = dict(fs.solver_timing)
            torch.cuda.synchronize()
            seen["reserved"] = torch.cuda.memory_reserved() / 2**20
            seen.update(lhs=lhs_t, rhs=rhs_t, x=x_t, x_fused=x_f, x_warm=x_w)
            return x_t

        fs.solve = recording_solve
        contexts = set()
        reserved = []
        ok = True
        for step in range(3):
            counts.reset()
            Vt = flow.step(tol=1e-4)
            launched = counts.read()
            res = fs.residual(seen["lhs"], seen["rhs"], seen["x"])
            contexts.update(id(c) for c in fs._contexts.values())
            tr, fu, wa = seen["traced"], seen["fused"], seen["warm"]
            reserved.append(seen["reserved"])
            same = (bool(np.array_equal(seen["x_fused"], seen["x"]))
                    and bool(np.array_equal(seen["x_warm"], seen["x"]))
                    and fu["iterations"] == tr["iterations"] == wa["iterations"])
            loop_ok = ((fu["host_reads"], fu["graph_launches"]) == (2, 1)
                       and (wa["host_reads"], wa["graph_launches"]) == (1, 1)
                       and fu["graph_captures"] == wa["graph_captures"] == 1)
            # each step's update_lhs hands the last step's graph pool back
            flat = step == 0 or reserved[-1] - reserved[-2] < fu["graph_pool_mib"]
            step_ok = (np.isfinite(Vt).all() and res <= 1e-4 and same and loop_ok
                       and flat
                       and len(fs._contexts) == 1 and len(contexts) == 1
                       and launched["sliced_spmv"] > 0
                       and launched["sliced_diag_spmv"] > 0
                       and launched["diag_spmv"] == 0)
            ok &= step_ok
            what = "context setup" if step == 0 else "update_lhs"
            log(f"phase flow: step {step} cycles "
                f"{int(tr['iterations'])} {what} "
                f"{seen['context_s'] * 1000:.1f} ms solve traced "
                f"{tr['cycles']:.2f} ms, fused cold {fu['cycles']:.2f} ms (captured "
                f"anew, {fu['graph_capture_ms']:.1f} ms, WHILE graph built in "
                f"{fu['graph_build_ms']:.2f} ms; graph pool {fu['graph_pool_mib']:.1f} MiB "
                f"at d=3 f64; host reads / graph launches cold "
                f"{int(fu['host_reads'])} / {int(fu['graph_launches'])}, warm "
                f"{int(wa['host_reads'])} / {int(wa['graph_launches'])}), fused warm "
                f"{wa['cycles']:.2f} ms, fused x == traced x {same}; reserved "
                f"{seen['reserved']:.0f} MiB; residual(host f64) {res:.3e} "
                f"contexts {len(fs._contexts)} launches {launched} "
                f"{'ok' if step_ok else 'FAIL'}")
        fs.solve = plain_solve
        log(f"phase flow: {layouts(next(iter(fs._contexts.values())))} "
            f"one context over 3 steps {len(contexts) == 1} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("1M conformal flow failed its checks")
        del flow, fs
        log(f"flow: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("flow", exc)

    # ---- 8. baselines at 262k: OURS, SIG06, ablation, SIG21 ------------------
    try:
        t_wall = time.perf_counter()
        ok = True
        for name, b in baselines.items():
            s = b["solver"]
            counts.reset()
            x = s.solve(lhs_b, rhs_b)
            launched = counts.read()
            cycles = int(s.solver_timing["iterations"])
            res = s.residual(lhs_b, rhs_b, x)
            this_ok = (np.isfinite(x).all() and x.shape == rhs_b.shape
                       and res <= 1e-4 and launched["sliced_spmv"] > 0)
            ok &= this_ok
            b["cycles"] = cycles
            log(f"phase baselines: {name} dof={b['dof']} hierarchy "
                f"{b['hierarchy_s']:.2f} s setup {b['setup_s']:.2f} s cycles "
                f"{cycles} (reference table {REFERENCE_CYCLES_262K[name]}) solve "
                f"{s.solver_timing['cycles']:.2f} ms residual(host f64) {res:.3e} "
                f"launches {launched} {'ok' if this_ok else 'FAIL'}")
            log(f"phase baselines: {name} {layouts(b['ctx'])}")
        if not ok:
            raise AssertionError("262k baselines failed their checks")
        log(f"baselines: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("baselines", exc)

    # ---- 9. hierarchy: the device engines on the card ------------------------
    try:
        t_wall = time.perf_counter()
        from gravo_mg_tpu_torch.hierarchy import cluster as hcluster
        from gravo_mg_tpu_torch.hierarchy import prolongation as hprolongation
        from gravo_mg_tpu_torch.hierarchy import sampling as hsampling
        from gravo_mg_tpu_torch.hierarchy.builder import build_hierarchy

        stages = ("edge_lengths", "sampling", "cluster", "next_neighborhood",
                  "next_positions", "triangle_selection", "prolongation_assembly")
        engines = ("sampling", "cluster", "triangle_selection")
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sd = MultigridSolver(V, neigh, M, lower_bound=1000, device="cuda",
                             hierarchy_engine="device")
        torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        build_mib = (torch.cuda.max_memory_allocated() - resident) / 2**20
        hd, hn = sd.hierarchy, solver.hierarchy
        log(f"phase hierarchy: 1M torus device build {t_dev:.3f} s (its timing "
            f"{hd.timing['hierarchy'] / 1e3:.3f} s), native build in phase "
            f"poisson-setup {hn.timing['hierarchy'] / 1e3:.3f} s")
        log("phase hierarchy: stage s device / native: " + ", ".join(
            f"{k} {hd.timing[k]:.4f} / {hn.timing[k]:.4f}" for k in stages)
            + f"; the three engines {sum(hd.timing[k] for k in engines):.4f} / "
            f"{sum(hn.timing[k] for k in engines):.4f}")
        log(f"phase hierarchy: dof device {hd.dof} native {hn.dof}; rounds per "
            f"level {[lvl.rounds for lvl in hd.levels]}; branch stats per level "
            f"device {[lvl.stats.tolist() for lvl in hd.levels]} native "
            f"{[lvl.stats.tolist() for lvl in hn.levels]}; peak device memory "
            f"of the build {build_mib:.0f} MiB above {resident / 2**20:.0f} MiB "
            f"resident")
        # Level 0's engines once more, each alone (wall time) and then
        # under torch.profiler (kernels, device busy time); the weights'
        # host pair-adjacency table apart as well.
        lv0 = hd.levels[0]
        edge0 = hsampling.edge_lengths_np(np.asarray(V, np.float64), neigh)
        graph0 = hsampling.graph_tensors(neigh, edge0, dev)
        radius0 = 2.0 * float(edge0[np.isfinite(edge0) & (edge0 > 0)].mean())
        runs = {
            "luby_attempt": lambda: hsampling.parallel_disk_sample(
                V, graph0[0], radius0, dist=graph0[1], engine="luby", device=dev),
            "bellman_ford": lambda: hcluster.cluster_labels(
                V, lv0.samples, graph0[0], dist=graph0[1], engine="device",
                device=dev),
            "pair_adj_host": lambda: hprolongation._pair_adjacency(lv0.coarse_neigh),
            "weights": lambda: hprolongation.prolongation_weights(
                V, lv0.labels, lv0.coarse_points, lv0.coarse_neigh,
                engine="device", device=dev),
        }
        parts = []
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with torch_trace(trace_dir, name=f"hierarchy_{name}") as prof:
                fn()
            evs = device_events(prof, f"hierarchy_{name}")
            kern = [e for e in evs if not e.name.startswith(("Memcpy", "Memset"))]
            busy, span = busy_span(evs) if evs else (0.0, 0.0)
            parts.append(f"{name} {wall:.4f} s, {len(kern)} kernels, device busy "
                         f"{busy / 1e3:.2f} of {span / 1e3:.2f} ms")
        log("phase hierarchy: level 0 once more (wall; traced kernels and "
            "device busy time): " + "; ".join(parts))
        del graph0
        t0 = time.perf_counter()
        ctx_d = sd._context(lhs)
        torch.cuda.synchronize()
        t_setup_d = time.perf_counter() - t0
        counts.reset()
        xd = sd.solve(lhs, rhs, mode="fused")
        launched = counts.read()
        cycles_d = int(sd.solver_timing["iterations"])
        res_d = sd.residual(lhs, rhs, xd)
        checks = {
            "cycles <= 6": cycles_d <= 6,
            "residual <= 1e-4": res_d <= 1e-4,
            "finite": bool(np.isfinite(xd).all()) and xd.shape == rhs.shape,
            "sliced_diag_spmv launched": launched["sliced_diag_spmv"] > 0,
            "sliced_spmv launched": launched["sliced_spmv"] > 0,
        }
        log(f"phase hierarchy: 1M Poisson on the device hierarchy: setup "
            f"{t_setup_d:.2f} s {layouts(ctx_d)} cycles {cycles_d} (native "
            f"hierarchy {cycles_single}) residual(host f64) {res_d:.3e} solve "
            f"{sd.solver_timing['cycles']:.2f} ms launches {launched}")
        del sd, ctx_d, xd
        torch.cuda.empty_cache()

        # The same engines on the card and on the CPU: the 65k torus
        V6, F6 = torus_mesh(256, 256)
        neigh6 = neighbors_from_faces(F6)
        t0 = time.perf_counter()
        hg = build_hierarchy(V6, neigh6, engine="device", device="cuda")
        t_gpu = time.perf_counter() - t0
        t0 = time.perf_counter()
        hc = build_hierarchy(V6, neigh6, engine="device", device="cpu")
        t_cpu = time.perf_counter() - t0
        same = hg.dof == hc.dof and all(
            np.array_equal(a.samples, b.samples) and np.array_equal(a.labels, b.labels)
            and np.array_equal(a.coarse_neigh, b.coarse_neigh) and a.rounds == b.rounds
            for a, b in zip(hg.levels, hc.levels))
        u_rows, stats_diff = [], []
        for a, b in zip(hg.levels, hc.levels):
            D = abs(a.U.to_scipy() - b.U.to_scipy()).tocsr()
            n6 = a.labels.shape[0]
            row_err = np.zeros(n6)
            np.maximum.at(row_err, np.repeat(np.arange(n6), np.diff(D.indptr)), D.data)
            u_rows.append(int((row_err > 1e-5).sum()))
            stats_diff.append(int(np.abs(a.stats - b.stats).max()))
        checks["65k card == CPU: samples, labels, coarse graphs, rounds"] = same
        checks["65k U rows within 1e-5 on >= 99.9%"] = all(
            u <= 1e-3 * n for u, n in zip(u_rows, hg.dof))
        checks["65k stats within 0.1% of N"] = all(
            s <= 1e-3 * n for s, n in zip(stats_diff, hg.dof))
        log(f"phase hierarchy: 65k torus dof {hg.dof} card {t_gpu:.3f} s CPU "
            f"{t_cpu:.3f} s; samples, labels, coarse graphs and rounds identical "
            f"{same}; U rows off by > 1e-5 per level {u_rows}; stats max diff "
            f"per level {stats_diff}")

        # SIG06 and ablation through the device engines, 262k
        for name, kw in (("sig06", {"sig06": True}), ("ablation", {"ablation": True})):
            t0 = time.perf_counter()
            s = MultigridSolver(Vb, neigh_b, Mb, device="cuda",
                                hierarchy_engine="device", **kw)
            t_h = time.perf_counter() - t0
            counts.reset()
            xb = s.solve(lhs_b, rhs_b)
            launched = counts.read()
            cycles = int(s.solver_timing["iterations"])
            res = s.residual(lhs_b, rhs_b, xb)
            checks[f"262k {name} residual <= 1e-4"] = (
                res <= 1e-4 and bool(np.isfinite(xb).all())
                and launched["sliced_spmv"] > 0)
            log(f"phase hierarchy: 262k {name} device build {t_h:.2f} s dof "
                f"{s.hierarchy.dof} (native {baselines[name]['dof']}) cycles "
                f"{cycles} (native hierarchy {baselines[name]['cycles']}) "
                f"residual(host f64) {res:.3e} launches {launched}")
        del s
        ok = all(checks.values())
        log(f"phase hierarchy: checks {[k for k, v in checks.items() if not v] or 'all passed'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("the device hierarchy engines failed their checks")
        log(f"hierarchy: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("hierarchy", exc)

    # ---- 10. comparisons: the port's harness at its default sizes ------------
    try:
        t_wall = time.perf_counter()
        if not comparisons_phase(trace_dir):
            raise AssertionError("the comparison harness failed its checks")
        log(f"comparisons: wall {time.perf_counter() - t_wall:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("comparisons", exc)

    sources = {
        "sliced_spmv": ("sliced_spmv.cu", "gravo_mg_tpu/ops/shuffle_spmv.py:87"),
        "diag_spmv": ("diag_spmv.cu", "gravo_mg_tpu/ops/diag_spmv.py:146"),
        "shuffle_spmv": ("shuffle_spmv.cu", "gravo_mg_tpu/ops/shuffle_spmv.py:87"),
        "sliced_diag_spmv": ("sliced_diag_spmv.cu", "gravo_mg_tpu/ops/diag_spmv.py:146"),
        "halo_spmv": ("sliced_spmv.cu", "gravo_mg_tpu/ops/shuffle_spmv.py:87"),
    }
    # ms, plain_ms, bound and library_ms at U0^T d=1 (sliced_spmv, and
    # shuffle_spmv on the JAX layout of the same matrix), A0 d=1 f32
    # (diag_spmv on A0's DiagEll, format-neutral bound; sliced_diag_spmv,
    # the layout's own bound) and the halo path's U0^T halo part d=1 f32
    # (halo_spmv; cuSPARSE on its compact CSR); launches summed over the
    # solve phases, for sliced_spmv, sliced_diag_spmv and halo_spmv also per
    # epilogue, with each epilogue's times from phase kernels (A0, A1, U0 at
    # d=1 f32; the residual's and the add's library time is cuSPARSE's
    # addmv; no single PyTorch call computes a Chebyshev step, so it has
    # none; halo_spmv's modes on the partitioned A0 and U0, with the whole
    # operation's times under "operation", its library time cuSPARSE's
    # addmv on the whole partitioned operator; the masked interior launches
    # under their interior kernel).
    kernels = [
        {"name": name, "route": "cuda",
         "source": f"gravo_mg_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": counts.total[name], "max_abs_err": kinfo[name]["err"],
         "ms": kinfo[name]["ms"], "plain_ms": kinfo[name]["plain_ms"],
         "bound_ms": kinfo[name]["bound_ms"], "bound_by": kinfo[name]["bound_by"],
         "library_ms": kinfo[name]["library_ms"],
         **({"launches_by_mode": counts.total_by_mode[name],
             "epilogues": kinfo[name]["epilogues"]}
            if name in counts.total_by_mode else {})}
        for name, (src, replaces) in sources.items()
    ]
    # The loop-control kernel of the WHILE graph (csrc/graph_loop.cu): the
    # device side of the JAX while_loop, no port of a TPU kernel; its
    # launches, the graph's and its bodies over phase poisson's fused solves.
    log(json.dumps({"loop": {
        "name": "loop_control_kernel", "route": "cuda",
        "source": "gravo_mg_tpu_torch/csrc/graph_loop.cu",
        "replaces": "jax.lax.while_loop, gravo_mg_tpu/solver/multigrid.py:206",
        **loop_info}}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--halo-rank"]:
        sys.exit(halo_rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] == ["--multigpu-only"]:
        sys.exit(multigpu_main())
    sys.exit(main())
