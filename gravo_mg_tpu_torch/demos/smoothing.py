"""Implicit mesh smoothing demo (reference: demos/smoothing.py:20-74).

    python -m gravo_mg_tpu_torch.demos.smoothing [--input mesh.obj] [--device cuda]

Solves ``(M + tau*S) x = M V`` with the cotan Laplacian and Voronoi mass
through the port's multigrid solver.  Reads an OBJ (or generates a bumpy
icosphere) and writes the smoothed mesh to ``--out``.  With ``--gui`` and
polyscope installed, shows the result.
"""

import argparse

import numpy as np


def load_or_generate(path):
    """(V, F) from an OBJ file, or a bumpy icosphere when ``path`` is None."""
    from ..utils.meshgen import icosphere

    if path is None:
        return icosphere(5, bump=0.2)
    V, F = [], []
    with open(path) as fh:
        for line in fh:
            t = line.split()
            if not t:
                continue
            if t[0] == "v":
                V.append([float(x) for x in t[1:4]])
            elif t[0] == "f":
                F.append([int(x.split("/")[0]) - 1 for x in t[1:4]])
    return np.asarray(V), np.asarray(F, dtype=np.int64)


def save_obj(path, V, F):
    with open(path, "w") as f:
        for v in V:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for a, b, c in F + 1:
            f.write(f"f {a} {b} {c}\n")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--input", type=str, default=None, help="OBJ mesh path")
    ap.add_argument("--tau", type=float, default=1e-3)
    ap.add_argument("--out", type=str, default="smoothed.obj")
    ap.add_argument("--gui", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from .. import MultigridSolver
    from ..utils.laplacian import cotan_laplacian, mass_voronoi
    from ..utils.neighbors import neighbors_from_faces
    from ..utils.normalize import normalize_area

    V, F = load_or_generate(args.input)
    V = normalize_area(V, F)
    print(f"mesh: {V.shape[0]} vertices")
    S = cotan_laplacian(V, F)
    M = mass_voronoi(V, F)
    neigh = neighbors_from_faces(F)

    solver = MultigridSolver(V, neigh, M, device=args.device)
    lhs = (M + args.tau * S).tocsr()
    Vs = solver.solve(lhs, M @ V)
    print(
        f"solved on {solver.device} in "
        f"{solver.solver_timing['iterations']:.0f} cycles, "
        f"residual {solver.solver_timing['residue']:.2e}"
    )
    save_obj(args.out, Vs, F)
    print(f"wrote {args.out}")

    if args.gui:
        try:
            import polyscope as ps
        except ImportError:
            print("polyscope not installed; skipping GUI")
        else:
            ps.init()
            ps.register_surface_mesh("input", V, F)
            ps.register_surface_mesh("smoothed", Vs, F)
            ps.show()


if __name__ == "__main__":
    main()
