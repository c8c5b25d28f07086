"""Benchmark harness: run the solver suite over a mesh directory.

    python -m gravo_mg_tpu_torch.experiments.comparisons [--device cpu] ...

The port's counterpart of ``experiments/comparisons.py`` (itself the
reference harness, ``experiments/python/comparisons.py:57-229``): the same
flags, the same workload constructions (smoothing ``M + tau*S``, Poisson
``tau*M + S``, bilaplacian ``S M^-1 S`` variants, smoothed-spike or random
RHS), the same generated shapes when no mesh directory is given, and the
same sections (direct, SIG21, SIG06, CG, ours or, with ``--ablation``, the
ablation hierarchy) writing the same CSV schema, which both packages'
``comparisons_to_table.save_to_table`` read.  PyAMG runs only where it
imports; the direct solver is the host's CHOLMOD or SuperLU, its times
filling both the eigen and pardiso columns.

Differences: the solves run on ``--device`` (``cuda`` by default, which
raises without a GPU; ``cpu`` takes the plain PyTorch SpMVs) in
``--mode`` (``traced``, the facade's default, or ``fused``, the device
loop), and each multigrid and CG solve is repeated once on the same solver
and system: its CSV row is the first (cold) solve's, as the reference
writes it, with the second (warm) solve's device-loop ms beside it
(``warm_cycles``; CG: ``cg_warm_solver``).  The harness imports nothing of
JAX.
"""

import argparse
import pathlib
import time

import numpy as np
import torch
from scipy import sparse

from .. import Hierarchy, MultigridSolver, Sampling, Weighting
from ..utils.io import write_convergence_csv, write_timing_csv
from ..utils.laplacian import (
    cotan_laplacian,
    mass_voronoi,
    mesh_laplacian_robust,
    per_vertex_normals,
    point_cloud_laplacian,
)
from ..utils.neighbors import neighbors_from_stiffness
from ..utils.normalize import normalize_area, normalize_bounding_box


def read_mesh(path):
    """OBJ/OFF/PLY reader (reference util.read_mesh uses igl + plyfile,
    experiments/python/util.py:5-15)."""
    path = pathlib.Path(path)
    V, F = [], []
    if path.suffix == ".ply":
        from ..utils.io import read_ply

        V, F = read_ply(path)
        if F is None:
            raise ValueError(f"{path} has no faces; use --pointcloud")
        return np.asarray(V), np.asarray(F, dtype=np.int64)
    if path.suffix == ".obj":
        for line in open(path):
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                V.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                F.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
    elif path.suffix == ".off":
        lines = [l.split() for l in open(path) if l.strip() and not l.startswith("#")]
        assert lines[0][0] == "OFF"
        nv, nf, _ = (int(x) for x in lines[1][:3])
        for l in lines[2 : 2 + nv]:
            V.append([float(x) for x in l[:3]])
        for l in lines[2 + nv : 2 + nv + nf]:
            F.append([int(x) for x in l[1:4]])
    else:
        raise ValueError(f"unsupported mesh format: {path.suffix}")
    return np.asarray(V), np.asarray(F, dtype=np.int64)


def list_shapes(dir_path):
    d = pathlib.Path(dir_path)
    if not d.exists():
        return []
    return sorted(
        e for e in d.iterdir()
        if e.is_file() and e.suffix in (".obj", ".off", ".ply")
    )


def generated_shapes(sizes):
    """Procedural stand-ins for the paper's mesh suite."""
    from ..utils.meshgen import icosphere, torus_mesh

    shapes = []
    for tag, size in sizes:
        if tag == "sphere":
            V, F = icosphere(size, bump=0.15)
            shapes.append((f"sphere_{V.shape[0]//1000}k", V, F))
        else:
            nu = int(np.sqrt(size * 2)); nv = max(nu // 2, 8)
            V, F = torus_mesh(nu, nv, r=0.5)
            shapes.append((f"torus_{V.shape[0]//1000}k", V, F))
    return shapes


def preprocess(V, args, F=None):
    """Reference preprocess (comparisons.py:30-55), incl. the robust
    (non-manifold-safe) Laplacian branch and --robust_neigh."""
    robust = args.robust or args.nonmanifold
    if not args.pointcloud:
        V = normalize_area(V, F)
        N = per_vertex_normals(V, F)
        if robust:
            S, M = mesh_laplacian_robust(V, F)
        else:
            S = cotan_laplacian(V, F)
            M = mass_voronoi(V, F)
    else:
        V = normalize_bounding_box(V)
        N = None
        S, M = point_cloud_laplacian(V)
    Minv = sparse.diags(1.0 / M.diagonal())
    if args.robust_neigh and not args.pointcloud:
        S_robust, _ = mesh_laplacian_robust(V, F)
        neigh = neighbors_from_stiffness(S_robust)
    else:
        neigh = neighbors_from_stiffness(S)
    B = S @ Minv @ S
    return V, F, N, M, S, neigh, B


def solve_cold_warm(solver, lhs, rhs, mode):
    """Solve twice on one solver; returns the first (cold) solve's timing
    with the second's device-loop ms as ``warm_cycles`` (and, in fused
    mode, its host reads and graph launches as ``warm_host_reads`` and
    ``warm_graph_launches``), and the first's convergence."""
    solver.solve(lhs, rhs, mode=mode)
    timing, convergence = dict(solver.solver_timing), list(solver.convergence)
    solver.solve(lhs, rhs, mode=mode)
    warm = solver.solver_timing
    timing["warm_cycles"] = warm["cycles"]
    for key in ("host_reads", "graph_launches"):
        if key in warm:
            timing["warm_" + key] = warm[key]
    return timing, convergence


def run(args):
    shapes = []
    if args.in_dir and list_shapes(args.in_dir):
        for f in list_shapes(args.in_dir):
            if args.pointcloud:
                # Point-cloud runs read positions only (reference
                # comparisons.py:67-69 via util.read_pointcloud).
                from ..utils.io import read_pointcloud

                V, F = read_pointcloud(f), None
            else:
                try:
                    V, F = read_mesh(f)
                except ValueError as e:
                    print(f"skipping {f.name}: {e}")
                    continue
            shapes.append((f.stem, V, F))
        print(f"{len(shapes)} files found in '{args.in_dir}'")
    else:
        sizes = [("sphere", 5), ("torus", 16384), ("sphere", 6), ("torus", 65536)]
        if args.large:
            sizes += [("torus", 262144), ("sphere", 7), ("torus", 524288)]
        shapes = generated_shapes(sizes)
        print(f"generated {len(shapes)} procedural shapes")

    out = pathlib.Path(args.out_dir)
    for sub in ("ours", "sig06", "sig21"):
        (out / "convergence" / sub).mkdir(parents=True, exist_ok=True)
    dtype = torch.float64 if args.f64 else torch.float32
    common = dict(ratio=args.ratio, lower_bound=args.lower_bound,
                  tolerance=args.tolerance, dtype=dtype, device=args.device)

    for i, (name, V, F) in enumerate(shapes):
        print(f"Shape {i + 1}/{len(shapes)}: {name} ({V.shape[0]} verts)")
        V, F, N, M, S, neigh, B = preprocess(V, args, F)

        if args.poisson:
            lhs = M * args.tau + (B if args.bilaplacian else S)
        else:
            lhs = M + args.tau * (B if args.bilaplacian else S)
        lhs = lhs.tocsr()

        rng = np.random.default_rng(seed=args.seed)
        solver = MultigridSolver(
            V, neigh, M, nested=args.nested, sampling_strategy=args.sampling,
            verbose=args.verbose, **common,
        )
        if args.input_smooth:
            max_idx = int(np.argmax(V.sum(axis=1)))
            min_idx = int(np.argmin(V.sum(axis=1)))
            y = np.zeros((V.shape[0], 1))
            y[max_idx] = 1
            y[min_idx] = -1
            y = solver.solve((M + 0.5 * S).tocsr(), M @ y).reshape(-1)
            y = y + rng.standard_normal(V.shape[0]) * 5e-7
            y = y[:, None]
        else:
            y = rng.standard_normal((V.shape[0], 1))
        rhs = M @ y

        if args.direct:
            print("  direct solver")
            solver.direct_solve(lhs, rhs)
            # one host factorization fills both eigen + pardiso columns
            solver.solver_timing["pardiso_factor"] = solver.solver_timing["direct_factor"]
            solver.solver_timing["pardiso_solve"] = solver.solver_timing["direct_solve"]
            solver.write_solver_timing(
                name, out / f"direct_tau{args.tau}_{args.label}.csv",
                write_headers=i == 0,
            )

        if args.sig21:
            print("  sig21")
            solver.construct_sig21_hierarchy(F)
            solver.write_hierarchy_timing(
                name, out / f"hierarchy_sig21_{args.label}.csv",
                write_headers=i == 0,
            )
            solver.toggle_hierarchy(Hierarchy.SIG21)
            timing, conv = solve_cold_warm(solver, lhs, rhs, args.mode)
            write_timing_csv(out / f"solver_sig21_tau{args.tau}_{args.label}.csv",
                             name, timing, write_headers=i == 0)
            write_convergence_csv(
                out / f"convergence/sig21/{name}_tau{args.tau}_{args.label}.csv", conv)
            solver.toggle_hierarchy(Hierarchy.OURS)

        if args.sig06:
            print("  sig06")
            s06 = MultigridSolver(V, neigh, M, sig06=True, **common)
            s06.write_hierarchy_timing(
                name, out / f"hierarchy_sig06_{args.label}.csv",
                write_headers=i == 0,
            )
            timing, conv = solve_cold_warm(s06, lhs, rhs, args.mode)
            write_timing_csv(out / f"solver_sig06_tau{args.tau}_{args.label}.csv",
                             name, timing, write_headers=i == 0)
            write_convergence_csv(
                out / f"convergence/sig06/{name}_tau{args.tau}_{args.label}.csv", conv)

        if args.amg:
            try:
                from pyamg import ruge_stuben_solver, smoothed_aggregation_solver
            except ImportError:
                print("  pyamg not installed; skipping --amg")
            else:
                for tag, make_amg in (
                    ("rs", ruge_stuben_solver), ("sa", smoothed_aggregation_solver)
                ):
                    t = time.perf_counter()
                    amg = make_amg(lhs)
                    h_time = time.perf_counter() - t
                    iters = [0]

                    def cb(xk):
                        if solver.residual(lhs, rhs[:, 0], xk) > args.tolerance:
                            iters[0] += 1

                    amg.solve(rhs[:, 0], tol=1e-12, callback=cb)
                    t = time.perf_counter()
                    amg.solve(rhs[:, 0], tol=1e-12, maxiter=max(iters[0], 1))
                    s_time = time.perf_counter() - t
                    f = out / f"amg_{tag}_tau{args.tau}_{args.label}.csv"
                    with open(f, "w" if i == 0 else "a") as fh:
                        if i == 0:
                            fh.write(f"experiment,{tag}_hierarchy,{tag}_iterations,{tag}_solver\n")
                        fh.write(f"{name},{h_time},{iters[0]},{s_time}\n")

        if args.cg:
            print("  CG")
            cg_ms = []
            for _ in range(2):     # cold, then warm (the facade keeps CG's unit)
                try:
                    t = time.perf_counter()
                    solver.cg_solve(lhs, rhs)
                    cg_ms.append((time.perf_counter() - t) * 1000)
                except Exception as e:  # noqa: BLE001 — keep the suite alive
                    print(f"  CG failed: {e}")
                    cg_ms.append(float("nan"))
            f = out / f"cg_tau{args.tau}_{args.label}.csv"
            with open(f, "w" if i == 0 else "a") as fh:
                if i == 0:
                    fh.write("experiment,cg_solver,cg_warm_solver\n")
                fh.write(f"{name},{cg_ms[0]},{cg_ms[1]}\n")

        for j in range(args.num_repetitions):
            print(f"  ours ({j + 1}/{args.num_repetitions})")
            solver = MultigridSolver(
                V, neigh, M, normals=N, check_voronoi=not args.all_triangles,
                nested=args.nested, sampling_strategy=args.sampling,
                weighting=args.weighting, ablation=args.ablation,
                ablation_num_points=args.ablation_n,
                ablation_random=args.ablation_random, seed=args.seed + j,
                **common,
            )
            solver.write_hierarchy_timing(
                name, out / f"hierarchy_ours_{args.label}.csv",
                write_headers=(i == 0 and j == 0),
            )
            timing, conv = solve_cold_warm(solver, lhs, rhs, args.mode)
            write_timing_csv(out / f"solver_ours_tau{args.tau}_{args.label}.csv",
                             name, timing, write_headers=(i == 0 and j == 0))
            write_convergence_csv(
                out / f"convergence/ours/{name}_tau{args.tau}_{args.label}.csv", conv)


def build_parser():
    p = argparse.ArgumentParser(description="Run MultigridSolver benchmark")
    p.add_argument("--tau", type=float, default=1e-3)
    p.add_argument("--ratio", type=float, default=8)
    p.add_argument("--lower_bound", type=int, default=1000)
    p.add_argument("--tolerance", type=float, default=1e-4)
    p.add_argument("--label", type=str, default="laplacian")
    p.add_argument("--in_dir", type=str, default=None)
    p.add_argument("--out_dir", type=str, default="out/timing")
    p.add_argument("--num_repetitions", type=int, default=1)
    p.add_argument("--bilaplacian", action="store_true")
    p.add_argument("--poisson", action="store_true")
    p.add_argument("--input_smooth", action="store_true")
    p.add_argument("--pointcloud", action="store_true")
    p.add_argument("--nonmanifold", action="store_true",
                   help="input meshes are non-manifold: use the robust "
                        "Laplacian and skip sig21 (needs manifold collapses)")
    p.add_argument("--robust", action="store_true",
                   help="use the mollified non-manifold-safe Laplacian "
                        "(reference comparisons.py --robust)")
    p.add_argument("--robust_neigh", action="store_true")
    p.add_argument("--all_triangles", action="store_true")
    p.add_argument("--nested", action="store_true")
    p.add_argument("--direct", action="store_true")
    p.add_argument("--nosig21", action="store_true")
    p.add_argument("--sig06", action="store_true")
    p.add_argument("--amg", action="store_true")
    p.add_argument("--cg", action="store_true")
    p.add_argument("--large", action="store_true",
                   help="include larger generated meshes")
    p.add_argument("--sampling", type=str, default="fastdisk",
                   choices=["fastdisk", "poissondisk", "random", "fps", "mis"])
    p.add_argument("--weighting", type=str, default="barycentric",
                   choices=["barycentric", "uniform", "invdist"])
    p.add_argument("--ablation", action="store_true")
    p.add_argument("--ablation_n", type=int, default=3)
    p.add_argument("--ablation_random", action="store_true")
    p.add_argument("--f64", action="store_true",
                   help="end-to-end float64 solve path (tight-tolerance "
                        "convergence protocol, tol<=1e-12)")
    p.add_argument("--no_names", action="store_true")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="where the solves run: cuda (default) or cpu")
    p.add_argument("--mode", type=str, default="traced",
                   choices=["traced", "fused"],
                   help="the multigrid solves' loop: the host loop (traced) "
                        "or the device loop (fused)")
    return p


def parse_args(argv=None):
    """The parser's arguments with the enums and the SIG21 switch resolved."""
    args = build_parser().parse_args(argv)
    args.sampling = {
        "fastdisk": Sampling.FASTDISK, "poissondisk": Sampling.POISSONDISK,
        "random": Sampling.RANDOM, "fps": Sampling.FPS, "mis": Sampling.MIS,
    }[args.sampling]
    args.weighting = {
        "barycentric": Weighting.BARYCENTRIC, "uniform": Weighting.UNIFORM,
        "invdist": Weighting.INVDIST,
    }[args.weighting]
    args.sig21 = not (args.pointcloud or args.nonmanifold) and not args.nosig21
    return args


def main(argv=None):
    args = parse_args(argv)
    out = pathlib.Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    details = args.label + "\n--\nSettings:\n--\n" + "".join(
        f"{k}: {v}\n" for k, v in vars(args).items()
    ) + f"solver_device: {name}\n"
    (out / f"settings_{args.label}_tau{args.tau}.txt").write_text(details)
    print(details + "---")

    run(args)
    from .comparisons_to_table import save_to_table

    return save_to_table(
        str(out), args.tau, args.label, sig21=args.sig21, sig06=args.sig06,
        amg=args.amg, direct=args.direct, cg=args.cg,
        names_counts=not args.no_names,
    )


if __name__ == "__main__":
    main()
