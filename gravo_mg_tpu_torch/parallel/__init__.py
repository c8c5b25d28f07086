"""Row-partitioned multigrid over ``torch.distributed``.

Counterpart of ``gravo_mg_tpu/parallel/``: :mod:`.halo` holds the
distributed solver (``HaloContext``) and :mod:`.multihost` the process
bring-up and the partition mesh.  ``parallel/dist.py`` (the reference's
GSPMD cross-check) has no counterpart.
"""

from .halo import HaloContext, SolverMesh, make_solver_mesh
from .multihost import global_row_mesh, initialize

__all__ = [
    "HaloContext",
    "SolverMesh",
    "make_solver_mesh",
    "global_row_mesh",
    "initialize",
]
