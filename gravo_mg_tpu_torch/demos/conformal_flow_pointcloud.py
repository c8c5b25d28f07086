"""Point-cloud flow demo (reference: demos/conformal_flow_pointcloud.py).

    python -m gravo_mg_tpu_torch.demos.conformal_flow_pointcloud [--n 20000] [--device cuda]

The implicit flow on a raw point cloud: the Laplacian comes from
``point_cloud_laplacian`` (kNN graph) and the solver's neighborhoods from
the stiffness sparsity, with no faces anywhere.  Writes
``<out>_<step>.npy``.
"""

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--tau", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", type=str, default="pc_flow")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from .. import MultigridSolver
    from ..utils.laplacian import point_cloud_laplacian
    from ..utils.meshgen import point_cloud
    from ..utils.neighbors import neighbors_from_stiffness
    from ..utils.normalize import normalize_bounding_box

    P = normalize_bounding_box(point_cloud(args.n, seed=3))
    print(f"point cloud: {P.shape[0]} points")

    for step in range(args.steps):
        S, M = point_cloud_laplacian(P)
        neigh = neighbors_from_stiffness(S)
        solver = MultigridSolver(P, neigh, M, device=args.device)
        lhs = (M + args.tau * S).tocsr()
        P = solver.solve(lhs, M @ P)
        P = normalize_bounding_box(P)
        print(
            f"step {step}: dof={solver.hierarchy.dof} "
            f"{solver.solver_timing['iterations']:.0f} cycles, "
            f"residual {solver.solver_timing['residue']:.2e}"
        )
        np.save(f"{args.out}_{step:03d}.npy", P)
    print(f"wrote {args.out}_*.npy")


if __name__ == "__main__":
    main()
