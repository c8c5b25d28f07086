#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
last line):

1. build: the native host library (g++) and both CUDA kernels (nvcc,
   sm_90a) from the sources in this checkout;
2. kernels: each kernel against its plain PyTorch version on the card at
   the 1M Poisson case's real operator shapes (A0 DiagEll; U0^T, A1, M
   ShuffleEll), d = 1 and 3, f32 (plus one f64 check each), with times;
3. smoothing: the 10k icosphere(5, bump=0.15) smoothing solve
   (M + 1e-3 S, rhs M @ V) through MultigridSolver(device="cuda"),
   checked against a host SuperLU solve;
4. poisson: the 1M-vertex torus Poisson solve (1e-6 M + S, rhs M @ randn,
   seed 42, tol 1e-4, criterion 2, lower_bound 1000) through the facade
   in mode="fused", with both kernels' launch counts from that solve.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script needs CUDA and
the rest of the repository; without either it exits non-zero.
"""

import json
import subprocess
import sys
import time
import traceback

import numpy as np

TOL_F32 = 1e-5    # kernel vs plain, relative to max |y|
TOL_F64 = 1e-12


def log(msg=""):
    print(msg, flush=True)


def fail(phase, exc=None):
    log(f"FAILED phase {phase}")
    if exc is not None:
        traceback.print_exc()
    sys.exit(1)


def cuda_time_ms(fn, reps):
    import torch

    fn()   # warm
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def main():
    import torch

    if not torch.cuda.is_available():
        log("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        return 2
    import gravo_mg_tpu_torch  # noqa: F401  (fails outside the repository)
    from gravo_mg_tpu_torch import MultigridSolver, native
    from gravo_mg_tpu_torch.ops import build
    from gravo_mg_tpu_torch.ops import diag_spmv as dmod
    from gravo_mg_tpu_torch.ops import shuffle_spmv as smod
    from gravo_mg_tpu_torch.sparse import DiagEll, ShuffleEll
    from gravo_mg_tpu_torch.utils.laplacian import (
        cotan_laplacian, mass_barycentric, mass_voronoi,
    )
    from gravo_mg_tpu_torch.utils.meshgen import icosphere, torus_mesh
    from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"tf32: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    log(f"nvidia-smi: {smi.stdout.strip() or smi.stderr.strip()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    dev = torch.device("cuda")

    # ---- 1. build ----------------------------------------------------------
    try:
        t0 = time.perf_counter()
        native.get_lib()
        t1 = time.perf_counter()
        build.build_library()
        build.load_library()
        t2 = time.perf_counter()
        ptxas = [ln.strip() for ln in build.build_log.splitlines()
                 if "ptxas info" in ln and ("Used" in ln or "Compiling" in ln)]
        log(f"phase build: native g++ {t1 - t0:.1f} s, nvcc ({build.ARCH}) "
            f"{t2 - t1:.1f} s -> {build.LIBRARY.name}")
        for ln in ptxas:
            log(f"  {ln}")
    except Exception as exc:  # noqa: BLE001 — report and exit non-zero
        fail("build", exc)

    # ---- 1M system, hierarchy and setup (operators for phases 2 and 4) ---
    try:
        t0 = time.perf_counter()
        V, F = torus_mesh(1024, 1024)
        n = V.shape[0]
        S = cotan_laplacian(V, F)
        M = mass_barycentric(V, F)
        neigh = neighbors_from_faces(F)
        lhs = (1e-6 * M + S).tocsr()
        rhs = (M @ np.random.default_rng(42).standard_normal((n, 1)))[:, 0]
        t_mesh = time.perf_counter() - t0
        t0 = time.perf_counter()
        solver = MultigridSolver(V, neigh, M, lower_bound=1000, device="cuda")
        t_hier = time.perf_counter() - t0
        t0 = time.perf_counter()
        ctx = solver._context(lhs)
        torch.cuda.synchronize()
        t_setup = time.perf_counter() - t0
        log(f"1M system: n={n} nnz={lhs.nnz} mesh+operators {t_mesh:.2f} s, "
            f"hierarchy {t_hier:.2f} s, setup {t_setup:.2f} s")
    except Exception as exc:  # noqa: BLE001
        fail("poisson-setup", exc)

    # ---- 2. kernels vs plain at the 1M shapes ------------------------------
    cases = [
        ("A0", ctx.levels[0].A),
        ("U0T", ctx.transfers[0].UT),
        ("A1", ctx.levels[1].A),
        ("M", ctx.M),
    ]
    kinfo = {
        "diag_spmv": {"err": 0.0, "ms": None, "plain_ms": None},
        "shuffle_spmv": {"err": 0.0, "ms": None, "plain_ms": None},
    }
    rng = np.random.default_rng(0)
    try:
        for label, A in cases:
            kname = "diag_spmv" if isinstance(A, DiagEll) else "shuffle_spmv"
            if label == "A0" and kname != "diag_spmv":
                raise AssertionError("A0 is not planned as DiagEll")
            if label != "A0" and not isinstance(A, ShuffleEll):
                raise AssertionError(f"{label} is not a ShuffleEll")

            def run(x, v, plain):
                if isinstance(A, DiagEll):
                    f = dmod.diag_spmv_plain if plain else dmod.diag_spmv
                    return f(A.start, A.r, v, x, A.tg, A.nrows)
                f = smod.shuffle_spmv_plain if plain else smod.shuffle_spmv
                return f(A.q, A.r, v, x, A.nrows)

            shape = tuple(A.r.shape)
            slot_bytes = A.r.numel() * (1 + 4)
            for d in (1, 3):
                xs = rng.standard_normal((A.ncols,) if d == 1 else (A.ncols, d))
                x = torch.from_numpy(xs).to(dev, torch.float32)
                y = run(x, A.v, False)
                ref = run(x, A.v, True)
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                rel = err / max(ref.abs().max().item(), 1e-30)
                ok = rel <= TOL_F32 and bool(torch.isfinite(y).all())
                ms = cuda_time_ms(lambda: run(x, A.v, False), 20)
                pms = cuda_time_ms(lambda: run(x, A.v, True), 3)
                log(f"phase kernels: {kname} {label} {shape} d={d} f32 "
                    f"max_abs_err {err:.3e} rel {rel:.3e} (tol {TOL_F32}) "
                    f"kernel {ms:.4f} ms ({slot_bytes / ms / 1e6:.1f} GB/s of v+r) "
                    f"plain {pms:.4f} ms {'ok' if ok else 'MISMATCH'}")
                if not ok:
                    raise AssertionError(f"{kname} {label} d={d} disagrees")
                info = kinfo[kname]
                info["err"] = max(info["err"], err)
                if d == 1 and label in ("A0", "U0T"):
                    info["ms"], info["plain_ms"] = ms, pms
            # f64: the same layout with values widened exactly
            x = torch.from_numpy(rng.standard_normal(A.ncols)).to(dev)
            v64 = A.v.double()
            y, ref = run(x, v64, False), run(x, v64, True)
            rel = ((y - ref).abs().max() / ref.abs().max()).item()
            log(f"phase kernels: {kname} {label} d=1 f64 rel {rel:.3e} (tol {TOL_F64})")
            if not rel <= TOL_F64:
                raise AssertionError(f"{kname} {label} f64 disagrees")
            del x, v64, y, ref
        torch.cuda.empty_cache()
    except Exception as exc:  # noqa: BLE001
        fail("kernels", exc)

    # ---- 3. 10k smoothing solve ---------------------------------------------
    try:
        V2, F2 = icosphere(5, bump=0.15)
        S2, M2 = cotan_laplacian(V2, F2), mass_voronoi(V2, F2)
        s2 = MultigridSolver(V2, neighbors_from_faces(F2), M2, lower_bound=300,
                             device="cuda")
        lhs2 = (M2 + 1e-3 * S2).tocsr()
        rhs2 = M2 @ V2
        x2 = s2.solve(lhs2, rhs2)
        res2 = s2.residual(lhs2, rhs2, x2)
        xd = s2.direct_solve(lhs2, rhs2)
        rel2 = float(np.linalg.norm(x2 - xd) / np.linalg.norm(xd))
        ok = (x2.shape == rhs2.shape and np.isfinite(x2).all()
              and res2 <= 1e-4 and rel2 <= 1e-3)
        log(f"phase smoothing: n={len(V2)} dof={s2.hierarchy.dof} "
            f"cycles {int(s2.solver_timing['iterations'])} residual {res2:.3e} "
            f"vs SuperLU rel {rel2:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("10k smoothing solve failed its checks")
    except Exception as exc:  # noqa: BLE001
        fail("smoothing", exc)

    # ---- 4. the 1M Poisson solve (main path) ----------------------------------
    try:
        torch.cuda.reset_peak_memory_stats()
        smod.launches = 0
        dmod.launches = 0
        x = solver.solve(lhs, rhs, mode="fused")
        launches = {"shuffle_spmv": smod.launches, "diag_spmv": dmod.launches}
        cycles = int(solver.solver_timing["iterations"])
        cycles_ms = solver.solver_timing["cycles"]
        res = solver.residual(lhs, rhs, x)
        peak = torch.cuda.max_memory_allocated() / 2**20
        t0 = time.perf_counter()
        solver.solve(lhs, rhs, mode="fused")
        warm_s = time.perf_counter() - t0
        warm_ms = solver.solver_timing["cycles"]
        kinds = [type(lvl.A).__name__ for lvl in ctx.levels]
        ok = (np.isfinite(x).all() and x.shape == rhs.shape and res <= 1e-4
              and cycles <= 6 and launches["shuffle_spmv"] > 0
              and launches["diag_spmv"] > 0)
        log(f"phase poisson: dof={solver.hierarchy.dof} levels {kinds} "
            f"cycles {cycles} residual(host f64) {res:.3e} "
            f"trace {[f'{c[1]:.3e}' for c in solver.convergence]}")
        log(f"phase poisson: hierarchy {t_hier:.2f} s setup {t_setup:.2f} s "
            f"cycles {cycles_ms:.2f} ms ({cycles_ms / max(cycles, 1):.3f} ms/cycle) "
            f"warm solve cycles {warm_ms:.2f} ms (call {warm_s:.3f} s) "
            f"peak device memory {peak:.0f} MiB")
        log(f"phase poisson: launches {launches} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("1M Poisson solve failed its checks")
    except Exception as exc:  # noqa: BLE001
        fail("poisson", exc)

    kernels = [
        {"name": "diag_spmv", "route": "cuda",
         "source": "gravo_mg_tpu_torch/csrc/diag_spmv.cu",
         "replaces": "gravo_mg_tpu/ops/diag_spmv.py:146",
         "launches": launches["diag_spmv"],
         "max_abs_err": kinfo["diag_spmv"]["err"],
         "ms": kinfo["diag_spmv"]["ms"],
         "plain_ms": kinfo["diag_spmv"]["plain_ms"]},
        {"name": "shuffle_spmv", "route": "cuda",
         "source": "gravo_mg_tpu_torch/csrc/shuffle_spmv.cu",
         "replaces": "gravo_mg_tpu/ops/shuffle_spmv.py:86",
         "launches": launches["shuffle_spmv"],
         "max_abs_err": kinfo["shuffle_spmv"]["err"],
         "ms": kinfo["shuffle_spmv"]["ms"],
         "plain_ms": kinfo["shuffle_spmv"]["plain_ms"]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
