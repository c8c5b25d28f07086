"""Stored slots over structural nonzeros of the solve context's layouts,
``solver_timing["layout_slots"] / solver_timing["layout_nnz"]`` after the
first solve: every level operator and both directions of every transfer,
so the padding that uneven rows cost each cycle's sparse applies.  None
where the program does not count them."""


def read(run):
    t = run.context_timing
    if run.kind != "solve" or not t.get("layout_nnz"):
        return None
    return t["layout_slots"] / t["layout_nnz"]
