"""Multi-process support for the halo-exchange solver.

Counterpart of ``gravo_mg_tpu/parallel/multihost.py`` on
``torch.distributed``:

* **Process bring-up** (:func:`initialize`): a thin wrapper over
  ``torch.distributed.init_process_group``, idempotent, followed by one
  collective so that every rank has joined before the first batch of
  point-to-point transfers (NCCL requires the first ``batch_isend_irecv``
  of a group to involve every rank).  The backend is NCCL unless the
  caller asks for gloo (the CPU); CUDA tensors never go through gloo, and
  no GPU means an error, not a quiet switch to the CPU.
* **Mesh** (:func:`global_row_mesh`): ``partitions_per_rank`` row blocks
  on each rank, numbered process-major, so partition ``g`` lives on rank
  ``g // partitions_per_rank`` and consecutive row blocks share a rank;
  of each ring shift's transfers only the rank-boundary pairs leave it.
* **Array distribution** (:func:`host_to_global`): every rank runs the
  same host partitioner (the plans are deterministic) and keeps only its
  own partitions' slice; no host metadata is exchanged.
* **Inter-node first** (:func:`order_steps_dcn_first`): within one halo
  exchange, ring shifts whose transfers leave a node are posted before
  the shifts that stay on it.  "DCN" names the network between nodes,
  and ``local_device_count`` the partitions per node.

Runbook (N processes, e.g. ``torchrun --nproc-per-node N script.py``)::

    from gravo_mg_tpu_torch.parallel import multihost
    from gravo_mg_tpu_torch.parallel.halo import HaloContext
    multihost.initialize()                     # env:// from torchrun
    mesh = multihost.global_row_mesh(1, "cuda")
    ... build MultigridSolver / its context (host, identical per rank) ...
    hctx = HaloContext(ctx, mesh)
    x, iters, res = hctx.solve(rhs)                  # mode="fused"
    x, iters, res = hctx.solve(rhs, mode="traced")   # host loop, per-cycle times

Each rank passes the same full ``rhs``; every rank gets the full solution.
``mode="fused"`` (the default) captures one halo cycle, its NCCL
collectives and point-to-point transfers included, as a CUDA graph on the
first solve and runs it under a conditional WHILE node; its first cycle
runs eagerly and so creates every NCCL communicator before the capture.  Leave ``TORCH_NCCL_BLOCKING_WAIT`` unset:
a captured ``wait`` may only make the stream wait.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _backend_device(backend: str) -> torch.device:
    """The device a backend's tensors live on (NCCL: this rank's GPU)."""
    if backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the process group (idempotent).

    Arguments default to ``env://`` and the ``WORLD_SIZE``/``RANK``
    variables that ``torchrun`` sets.  ``backend`` defaults to NCCL, which
    raises without a GPU; pass ``backend="gloo"`` to run on the CPU.  With
    NCCL each rank takes the GPU ``LOCAL_RANK`` (or ``rank %
    device_count``).
    """
    if dist.is_initialized():
        return
    backend = backend or "nccl"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a GPU; none is available")
        local = os.environ.get("LOCAL_RANK")
        r = int(rank if rank is not None else os.environ.get("RANK", 0))
        torch.cuda.set_device(
            int(local) if local is not None else r % torch.cuda.device_count()
        )
    dist.init_process_group(
        backend=backend, init_method=init_method,
        world_size=-1 if world_size is None else int(world_size),
        rank=-1 if rank is None else int(rank),
    )
    # One collective over every rank before any point-to-point batch.
    dist.all_reduce(torch.zeros(1, device=_backend_device(backend)))


def global_row_mesh(partitions_per_rank: int = 1, device=None):
    """The process-major row mesh over every rank of the initialized group:
    ``world_size * partitions_per_rank`` partitions, this rank holding
    ``[rank * partitions_per_rank, (rank + 1) * partitions_per_rank)``.

    ``device`` defaults to the backend's device; a CUDA device needs the
    NCCL backend and a CPU device gloo.
    """
    from .halo import SolverMesh

    if not dist.is_initialized():
        raise RuntimeError("call multihost.initialize() first")
    backend = dist.get_backend()
    dev = _backend_device(backend) if device is None else torch.device(device)
    if dev.type == "cuda":
        if backend != "nccl":
            raise ValueError(f"a CUDA mesh needs the nccl backend, not {backend}")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif backend != "gloo":
        raise ValueError(f"a {dev.type} mesh needs the gloo backend, not {backend}")
    ppr = int(partitions_per_rank)
    if ppr < 1:
        raise ValueError("partitions_per_rank must be >= 1")
    world = dist.get_world_size()
    # torchrun's LOCAL_WORLD_SIZE: the ranks that share this node
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return SolverMesh(n_partitions=world * ppr, device=dev,
                      rank=dist.get_rank(), world_size=world, distributed=True,
                      partitions_per_node=per_node * ppr)


def host_to_global(mesh, arr: np.ndarray, dtype=None) -> torch.Tensor:
    """This rank's slice of a host array stacked over the partition axis
    (``arr.shape[0] == mesh.n_partitions``), as a tensor on the mesh's
    device.  Every rank holds the same full ``arr``."""
    arr = np.asarray(arr)
    if arr.shape[0] != mesh.n_partitions:
        raise ValueError(f"leading axis {arr.shape[0]} != {mesh.n_partitions} partitions")
    lo, hi = mesh.local_range
    t = torch.from_numpy(np.ascontiguousarray(arr[lo:hi]))
    return t.to(mesh.device, dtype)


def order_steps_dcn_first(steps, ndev: int, local_device_count: int):
    """Reorder halo-exchange steps so inter-node shifts are posted first.

    ``steps`` are ``(shift, send_idx, recv_pos)`` ring shifts (see
    parallel/halo.py).  With P partitions per node, a shift ``s`` moves
    ``D - count(d: same node)`` of its D transfers between nodes; steps
    are ranked by that count, descending, largest |shift| first as a
    tiebreak, so the slowest traffic overlaps the interior SpMV longest.
    """
    P_ = max(int(local_device_count), 1)

    def dcn_transfers(step):
        s = step[0]
        return sum(
            1 for d in range(ndev) if (d + s) % ndev // P_ != d // P_
        )

    return tuple(sorted(
        steps, key=lambda st: (-dcn_transfers(st), -abs(st[0]))
    ))
