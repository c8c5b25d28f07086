"""The procedural torus: ``mesh = {"kind": "torus", "nu", "nv", "R", "r",
"normalize_area"}``, cotan stiffness, barycentric mass, ``h`` the mean edge
length."""

from __future__ import annotations

from ..mesh import (
    cotan_laplacian,
    mass_barycentric,
    mean_edge_length,
    normalize_area,
    torus_mesh,
)
from . import Inputs


def make(mesh: dict) -> Inputs:
    V, F = torus_mesh(mesh["nu"], mesh["nv"], R=mesh.get("R", 1.0),
                      r=mesh.get("r", 0.4))
    if mesh.get("normalize_area", False):
        V = normalize_area(V, F)
    return Inputs(V, F,
                  lambda: (cotan_laplacian(V, F), mass_barycentric(V, F)),
                  lambda inputs: mean_edge_length(inputs.V, inputs.F))
