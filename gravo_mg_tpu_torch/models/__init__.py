"""Model problems (workloads) built on the solver stack.

Counterpart of ``gravo_mg_tpu/models``: the reference's demo and experiment
systems as reusable components.
"""

from .problems import (  # noqa: F401
    ConformalFlow,
    ProblemSetup,
    poisson_problem,
    smoothing_problem,
)

__all__ = [
    "ConformalFlow",
    "ProblemSetup",
    "poisson_problem",
    "smoothing_problem",
]
