"""The solve context's set-up spans in ``solver_timing`` after the first
solve, in s: LHS analysis, mass upload, Galerkin chain and patterns
(``plan_build``), layouts and transfers (``shuffle_plan``), the value
gather map and the value reduction and upload."""

KEYS = ("setup_analyze", "setup_mass", "plan_build", "shuffle_plan",
        "setup_csr_src", "reduction")


def read(run):
    t = run.context_timing
    if not all(k in t for k in KEYS):
        return None
    return sum(t[k] for k in KEYS) / 1000.0
