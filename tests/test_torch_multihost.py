"""The port's halo solver across processes (``torch.distributed``, gloo).

``test_two_process_halo_solve`` runs this file as a script in two
processes on the CPU, two partitions each (D = 4), joined through a
``file://`` rendezvous in ``tmp_path``.  Each worker does what
``tests/multihost_worker.py`` does for the JAX package: ``torus_mesh(48,
48)``, ``M + 1e-3 S``, tol 1e-6, and asserts ``res < 1e-6``, a solution
within 1e-4 relative of its own single-device solve, and the same
iteration count, for the host loop (``mode="traced"``) and the device
loop (``mode="fused"``, which the CPU steps eagerly); every rank stops
after the same cycle, and the fused iterate equals the traced one bit for
bit.  ``test_four_process_halo_solve`` runs four ranks of one
partition each, ``test_one_process_gloo_world`` a one-rank world that
holds four partitions.  The workers import no JAX.

    python tests/test_torch_multihost.py <rank> <world> <init file> <partitions per rank>
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _worker(rank: int, world: int, init_file: str, ppr: int) -> None:
    import numpy as np
    import torch

    torch.set_num_threads(1)
    from gravo_mg_tpu_torch import MultigridSolver
    from gravo_mg_tpu_torch.parallel import multihost
    from gravo_mg_tpu_torch.parallel.halo import HaloContext
    from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_barycentric
    from gravo_mg_tpu_torch.utils.meshgen import torus_mesh
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

    multihost.initialize(init_method=f"file://{init_file}", world_size=world,
                         rank=rank, backend="gloo")
    multihost.initialize()        # idempotent
    mesh = multihost.global_row_mesh(ppr, "cpu")
    assert mesh.n_partitions == world * ppr and mesh.rank == rank

    V, F = torus_mesh(48, 48)
    S = cotan_laplacian(V, F)
    M = mass_barycentric(V, F)
    lhs = (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(7).standard_normal(V.shape[0])
    solver = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=200,
                             device="cpu")
    ctx = solver._context(lhs)
    hctx = HaloContext(ctx, mesh)
    remote = sum(len(op.sends) + len(op.recvs)
                 for lvl in hctx.levels for op in (lvl.A, lvl.U.U, lvl.U.UT))
    assert (remote > 0) == (world > 1), remote
    import torch.distributed as dist

    x_ref, it_ref, _, _ = ctx.solve(rhs, tol=1e-6, criteria=2)
    traced = hctx.solve(rhs, tol=1e-6, criteria=2, mode="traced")
    for mode in ("traced", "fused"):
        x, iters, res = hctx.solve(rhs, tol=1e-6, criteria=2, mode=mode)
        print(f"r{rank}: {mode} iters={iters} res={res:.3e} remote transfers "
              f"{remote}", flush=True)
        assert res < 1e-6, res
        rel = np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref)
        print(f"r{rank}: {mode} rel-vs-single={rel:.3e} (iters {iters} vs {it_ref})",
              flush=True)
        assert rel < 1e-4, rel
        assert iters == it_ref, (iters, it_ref)
        # every rank stopped after the same cycle
        ran = [None] * world
        dist.all_gather_object(ran, (iters, hctx.dispatched))
        assert ran == [(iters, iters)] * world, ran
    # the fused loop's iterate is the host loop's, bit for bit
    assert np.array_equal(x, traced[0]) and (iters, res) == traced[1:], (iters, res)
    # multi-column rhs through the same exchange, both loops
    X, _, res3 = hctx.solve(M @ V, tol=1e-6, criteria=2)
    assert X.shape == V.shape and res3 < 1e-6, res3
    X_tr = hctx.solve(M @ V, tol=1e-6, criteria=2, mode="traced")[0]
    assert np.array_equal(X, X_tr)

    dist.destroy_process_group()
    print(f"r{rank}: MULTIHOST_OK", flush=True)


def _spawn(tmp_path, world: int, ppr: int):
    # Build the native host library here, once, before the workers start.
    from gravo_mg_tpu_torch import native

    native.get_lib()
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    init_file = os.path.join(str(tmp_path), "rendezvous")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             init_file, str(ppr)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for r in range(world)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out[-4000:]}"
        assert "MULTIHOST_OK" in out, f"worker {r} no OK marker:\n{out[-4000:]}"


def test_two_process_halo_solve(tmp_path):
    _spawn(tmp_path, world=2, ppr=2)


def test_four_process_halo_solve(tmp_path):
    """One partition per rank: every ring shift crosses ranks, and each
    rank sends to and receives from two different peers."""
    _spawn(tmp_path, world=4, ppr=1)


def test_one_process_gloo_world(tmp_path):
    _spawn(tmp_path, world=1, ppr=4)


def test_initialize_defaults_to_nccl_and_raises_without_gpu(tmp_path, monkeypatch):
    """No backend named means NCCL: without a GPU that raises before any
    process group exists, instead of quietly running gloo on the CPU."""
    import pytest
    import torch
    import torch.distributed as dist

    from gravo_mg_tpu_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="nccl"):
        multihost.initialize(init_method=f"file://{tmp_path / 'rendezvous'}",
                             world_size=1, rank=0)
    assert not dist.is_initialized()


def test_order_steps_dcn_first():
    from gravo_mg_tpu_torch.parallel.multihost import order_steps_dcn_first

    # 8 devices, 4 per process: shift 4 crosses for every device (8 DCN
    # transfers); shifts 1/-1 cross only at the process boundary (2);
    # shift 0 never crosses.
    steps = [(0, None, None), (1, None, None), (4, None, None),
             (-1, None, None)]
    ordered = order_steps_dcn_first(steps, 8, 4)
    assert ordered[0][0] == 4
    assert ordered[-1][0] == 0
    # single-host: pure |shift| ordering, no crossing
    ordered1 = order_steps_dcn_first(steps, 8, 8)
    assert [s for s, _, _ in ordered1] == [4, 1, -1, 0]


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]))
