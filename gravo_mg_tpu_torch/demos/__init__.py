"""Demos of the port, run as modules::

    python -m gravo_mg_tpu_torch.demos.smoothing [--input mesh.obj] [--device cpu]
    python -m gravo_mg_tpu_torch.demos.conformal_flow [--input mesh.obj]
    python -m gravo_mg_tpu_torch.demos.conformal_flow_pointcloud [--n 20000]

Counterparts of the root ``demos/``, with the same flags plus ``--device``
(default ``cuda``).
"""
