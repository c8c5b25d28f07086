"""CSV reporting + hierarchy serialization.

The writers match the reference's schema (`writeTiming`/`writeConvergence`,
gravomg/src/utility.cpp:106-149): timing rows are ``experiment,<sorted
keys>`` appended per experiment; convergence files are ``time,residue``
pairs.  Hierarchy (de)serialization is the port's checkpoint/resume
analog of the reference's externalizable prolongation state
(`set_prolongation_matrices`, core.cpp:86-88).
"""

from __future__ import annotations

import os
from typing import Iterable, Tuple

import numpy as np


def write_timing_csv(filename, experiment, timing: dict, write_headers=False):
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    keys = sorted(timing.keys())  # std::map iterates sorted — same layout
    mode = "w" if write_headers else "a"
    with open(filename, mode) as f:
        if write_headers:
            f.write("experiment" + "".join(f",{k}" for k in keys) + "\n")
        f.write(str(experiment) + "".join(f",{timing[k]}" for k in keys) + "\n")


def write_convergence_csv(filename, convergence: Iterable[Tuple[float, float]]):
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        f.write("time,residue\n")
        for t, r in convergence:
            f.write(f"{t},{r}\n")


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def read_ply(filename):
    """Read a PLY file: ``(V (n,3) f64, F (m,3) i64 or None)``.

    Self-contained replacement for the reference harness's ``plyfile``
    dependency (experiments/python/util.py:5-27): handles ascii and
    binary_little_endian, arbitrary extra vertex properties, and
    variable-length face lists (fast path for uniform triangle counts).
    """
    with open(filename, "rb") as f:
        assert f.readline().strip() == b"ply", "not a PLY file"
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)|('list', ct, it, name)])
        while True:
            line = f.readline()
            if not line:
                raise ValueError("unterminated PLY header")
            tok = line.decode("ascii", "replace").split()
            if not tok or tok[0] == "comment":
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "element":
                elements.append((tok[1], int(tok[2]), []))
            elif tok[0] == "property":
                if tok[1] == "list":
                    elements[-1][2].append(
                        ("list", _PLY_DTYPES[tok[2]], _PLY_DTYPES[tok[3]], tok[4])
                    )
                else:
                    elements[-1][2].append((tok[2], _PLY_DTYPES[tok[1]]))
            elif tok[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported PLY format: {fmt}")
        V, F = None, None
        for name, count, props in elements:
            is_list = any(p[0] == "list" for p in props)
            if fmt == "ascii":
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    names = [p[0] for p in props]
                    ix, iy, iz = (names.index(c) for c in ("x", "y", "z"))
                    V = np.array(
                        [[r[ix], r[iy], r[iz]] for r in rows], dtype=np.float64
                    )
                elif name == "face":
                    F = np.array(
                        [r[1:1 + int(r[0])] for r in rows], dtype=np.int64
                    )
            elif not is_list:
                dt = np.dtype([(p[0], "<" + p[1]) for p in props])
                data = np.frombuffer(f.read(count * dt.itemsize), dtype=dt,
                                     count=count)
                if name == "vertex":
                    V = np.stack(
                        [data[c].astype(np.float64) for c in ("x", "y", "z")],
                        axis=-1,
                    )
            else:
                # list element (faces): fast path assumes a uniform count,
                # validated; falls back to a sequential walk.
                assert props[0][0] == "list", "non-leading list property"
                _, ct, it, _ = props[0]
                cdt, idt = np.dtype("<" + ct), np.dtype("<" + it)
                buf = f.read()  # rest of file (faces are last in practice)
                if count == 0:
                    continue
                c0 = int(np.frombuffer(buf, dtype=cdt, count=1)[0])
                stride = cdt.itemsize + c0 * idt.itemsize
                if len(buf) >= count * stride:
                    rec = np.dtype(
                        [("n", "<" + ct), ("v", "<" + it, (c0,))]
                    )
                    arr = np.frombuffer(buf, dtype=rec, count=count)
                    if (arr["n"] == c0).all():
                        idx = arr["v"].astype(np.int64)
                    else:
                        idx = None
                else:
                    idx = None
                if idx is None:
                    off, out = 0, []
                    for _ in range(count):
                        c = int(np.frombuffer(buf, cdt, 1, off)[0])
                        off += cdt.itemsize
                        out.append(
                            np.frombuffer(buf, idt, c, off).astype(np.int64)
                        )
                        off += c * idt.itemsize
                    idx = np.array(out, dtype=np.int64)
                if name == "face":
                    F = idx
        return V, F


def read_pointcloud(filename):
    """Vertex positions of a .ply point cloud (reference
    util.read_pointcloud, experiments/python/util.py:17-27)."""
    V, _ = read_ply(filename)
    return V


def write_ply(pos, filename, faces=None):
    """Write positions (and optional triangles) as binary_little_endian PLY
    (reference util.write_ply, experiments/python/util.py:29-33)."""
    pos = np.ascontiguousarray(pos, dtype=np.float32)
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {pos.shape[0]}",
               "property float x", "property float y", "property float z"]
        if faces is not None:
            hdr += [f"element face {len(faces)}",
                    "property list uchar int vertex_indices"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode("ascii"))
        f.write(pos.tobytes())
        if faces is not None:
            faces = np.ascontiguousarray(faces, dtype=np.int32)
            rec = np.empty(
                len(faces), dtype=[("n", "u1"), ("v", "<i4", (faces.shape[1],))]
            )
            rec["n"] = faces.shape[1]
            rec["v"] = faces
            f.write(rec.tobytes())


def write_sparse_matrix(filename, A):
    """Text dump of a sparse matrix (utility.cpp:73-92 analog):
    ``rows cols nnz`` header then ``i j v`` triplets."""
    A = A.tocoo()
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    with open(filename, "w") as f:
        f.write(f"{A.shape[0]} {A.shape[1]} {A.nnz}\n")
        for i, j, v in zip(A.row, A.col, A.data):
            f.write(f"{i} {j} {v}\n")


def write_dense_matrix(filename, M):
    """Text dump of a dense matrix (utility.cpp:94-104
    ``writeMatrixToFile`` analog): tab-separated rows."""
    M = np.asarray(M)
    if M.ndim == 1:
        M = M[:, None]
    os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
    np.savetxt(filename, M, delimiter="\t", fmt="%.17g")


def save_hierarchy(filename, hierarchy):
    """Serialize a hierarchy to a .npz so expensive setup is reusable
    across processes (SURVEY.md §5 checkpoint/resume requirement)."""
    data = {
        "dof": np.asarray(hierarchy.dof, dtype=np.int64),
        "points": hierarchy.points,
        "neigh": hierarchy.neigh,
        "num_levels": np.asarray(len(hierarchy.levels)),
    }
    for k, lvl in enumerate(hierarchy.levels):
        # stored row-major (Nf, W); make_prolongation re-transposes on load
        data[f"U_cols_{k}"] = lvl.U.host_cols.T
        data[f"U_weights_{k}"] = lvl.U.host_weights.T
        data[f"U_ncoarse_{k}"] = np.asarray(lvl.U.ncoarse)
        data[f"samples_{k}"] = lvl.samples
        data[f"labels_{k}"] = lvl.labels
        data[f"coarse_points_{k}"] = lvl.coarse_points
        data[f"coarse_neigh_{k}"] = lvl.coarse_neigh
        data[f"stats_{k}"] = lvl.stats
    np.savez_compressed(filename, **data)


def load_hierarchy(filename):
    from ..hierarchy.builder import Hierarchy, HierarchyLevel
    from ..sparse import make_prolongation

    z = np.load(filename)
    levels = []
    for k in range(int(z["num_levels"])):
        levels.append(
            HierarchyLevel(
                U=make_prolongation(
                    z[f"U_cols_{k}"], z[f"U_weights_{k}"],
                    int(z[f"U_ncoarse_{k}"]),
                ),
                samples=z[f"samples_{k}"],
                labels=z[f"labels_{k}"],
                coarse_points=z[f"coarse_points_{k}"],
                coarse_neigh=z[f"coarse_neigh_{k}"],
                stats=z[f"stats_{k}"],
            )
        )
    return Hierarchy(
        [int(d) for d in z["dof"]], levels, z["points"], z["neigh"],
        {"hierarchy": 0.0},
    )
