"""The halo path's fused operations on the CPU: ``PartitionedOp.residual``,
``add`` and ``cheb`` (``gravo_mg_tpu_torch/parallel/halo.py``), each two
launches on the card, here their plain versions.

A row-partitioned operator applies its interior part (``sliced_spmv`` or
``sliced_diag_spmv``) and then its compact halo part (``halo_spmv``), which
adds each boundary row's halo sum into the interior's output.  The JAX
package's halo solver has XLA fuse that add and the cycle's elementwise
work (the residual, the prolongation's add, the Chebyshev step) around
its two Pallas calls; the port puts the same work into the two launches:
the interior launch applies the epilogue on the rows without a halo part
and leaves the raw sum on the boundary rows (a row mask), and
``halo_spmv_<mode>`` applies it there after the add.

On a 64 x 64 torus (the port's own hierarchy, ``lower_bound=200``),
D in {2, 4} partitions, f32 and f64, d in {1, 3}:

* every operation (first and later Chebyshev step, Jacobi, residual, add)
  of a ``PartitionedOp`` with a SlicedEll and a SlicedDiag interior, bit
  for bit equal to ``epilogue_plain`` after ``op(x)`` (the plain
  composition the cycle ran before), through the masked interior and
  ``halo_spmv`` in the same mode;
* ``halo_spmv_<mode>``'s plain version against ``index_add_`` then the
  epilogue computed on every row and taken at ``out_row`` (the other rows
  untouched);
* the masked interior's plain version: the full epilogue where the mask's
  bit is clear, the raw sum where it is set, ``d`` left as it was there;
* the dispatch: ``sparse.spmv_residual``, ``spmv_add``, ``cheb_step`` and
  ``ShuffleTransfer.prolong_add`` send a ``PartitionedOp`` to its own
  operations (moved here from ``tests/test_torch_epilogue.py``, where a
  ``PartitionedOp`` took the plain composition);
* the residual numerators of ``HaloContext`` (now ``b - A x``) bitwise
  equal to the ``A x - b`` they replaced;
* a whole halo solve, traced and fused, bitwise equal (x, cycles, residual,
  the fused loop's trace) to the same solve with
  ``chip_smoke.plain_compositions`` patched in; and the JAX package's
  ``HaloContext`` on the same hierarchy within the tolerance of
  ``tests/test_torch_halo.py::test_halo_context_matches_reference``.
"""

import contextlib

import numpy as np
import pytest
import torch

from gravo_mg_tpu import MultigridSolver as RefSolver
from gravo_mg_tpu.parallel import halo as ref_halo
from gravo_mg_tpu.parallel.dist import make_solver_mesh as ref_mesh
from gravo_mg_tpu_torch import MultigridSolver, convert, sparse
from gravo_mg_tpu_torch.ops import halo_spmv as hmod
from gravo_mg_tpu_torch.ops import sliced_diag_spmv as sdmod
from gravo_mg_tpu_torch.ops import sliced_spmv as slmod
from gravo_mg_tpu_torch.ops.epilogue import (
    epilogue_plain,
    masked_rows,
    row_mask_from_rows,
)
from gravo_mg_tpu_torch.parallel import halo
from gravo_mg_tpu_torch.solver import multigrid as mg
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_barycentric
from gravo_mg_tpu_torch.utils.meshgen import torus_mesh
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces

torch.set_num_threads(2)

DTYPES = {"f32": torch.float32, "f64": torch.float64}
C1, C2 = 0.3717, 0.8391
MODE = {"cheb_first": "cheb", "cheb_next": "cheb", "jacobi": "cheb",
        "residual": "residual", "add": "add"}


@pytest.fixture(scope="module")
def torus():
    """The 64 x 64 torus, lhs M + 1e-3 S, and the port's context on it
    (its operators as f64 csr, laid out by each test in its dtype)."""
    V, F = torus_mesh(64, 64)
    S, M = cotan_laplacian(V, F), mass_barycentric(V, F)
    lhs = (M + 1e-3 * S).tocsr()
    solver = MultigridSolver(V, neighbors_from_faces(F), M, lower_bound=200,
                             device="cpu", diag_min_groups=4)
    return {"V": V, "M": M, "S": S, "lhs": lhs, "solver": solver,
            "ctx": solver._context(lhs)}


def _op(torus, which, D, dtype, layout="sliced"):
    """A0 (``which="A"``, interior SlicedEll or, with ``layout="sdiag"``,
    SlicedDiag), U0 or U0^T of the torus as a PartitionedOp over D
    partitions on the CPU, as ``HaloContext`` lays them out."""
    ops = torus.setdefault("ops", {})
    key = (which, D, dtype, layout)
    if key not in ops:
        ctx = torus["ctx"]
        A, k_rows, k_cols = {"A": (ctx.chain_csr[0], 0, 0), "U": (ctx.U_csr[0], 0, 1),
                             "UT": (ctx.U_csr[0].T.tocsr(), 1, 0)}[which]
        nl = [halo.partition_rows(ctx.chain_csr[k].shape[0], D) for k in (0, 1)]
        plan = halo._halo_plan(A, D, nl[k_rows][0], nl[k_cols][0])
        ops[key] = halo.PartitionedOp(
            A, plan, halo.make_solver_mesh(D, "cpu"), nl[k_cols][1], nl[k_rows][1],
            dtype, 4 if layout == "sdiag" else None)
        interior = sparse.SlicedDiag if layout == "sdiag" else sparse.SlicedEll
        assert isinstance(ops[key].A, interior) and ops[key].Ah is not None
    return ops[key]


def _vec(rng, rows, d, dtype, scale=1.0):
    a = scale * rng.standard_normal((rows,) if d == 1 else (rows, d))
    return torch.from_numpy(a).to(dtype)


def _operands(op, rows, d, dtype, seed):
    """The epilogue's operands of ``op`` (a key of MODE) for ``rows``
    output rows: its keyword arguments for ``epilogue_plain``."""
    rng = np.random.default_rng(seed)
    if op == "residual":
        return {"b": _vec(rng, rows, d, dtype)}
    if op == "add":
        return {"z": _vec(rng, rows, d, dtype)}
    kw = {"b": _vec(rng, rows, d, dtype),
          "dinv": torch.from_numpy(0.5 + rng.random(rows)).to(dtype),
          "x": _vec(rng, rows, d, dtype), "d": None, "c1": None, "c2": C2,
          "keep_d": op != "jacobi"}
    if op == "cheb_next":
        kw.update(d=_vec(rng, rows, d, dtype, 0.1), c1=C1)
    return kw


def _equal(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


@contextlib.contextmanager
def _spies(monkeypatch):
    """Count the calls of each halo_spmv mode as ``parallel.halo`` makes
    them, and the interior calls that carry a row mask, inside the block
    (``monkeypatch`` is undone when it ends)."""
    calls = {}

    def spy(mod, name, masked=False):
        fn = getattr(mod, name)

        def wrapped(*args, **kw):
            if not masked or kw.get("row_mask", args[-1]) is not None:
                calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("halo_spmv", "halo_spmv_residual", "halo_spmv_add", "halo_spmv_cheb"):
        spy(halo, name)
    for mod, names in ((slmod, ("sliced_spmv_residual", "sliced_spmv_add",
                                "sliced_spmv_cheb")),
                       (sdmod, ("sliced_diag_spmv_residual", "sliced_diag_spmv_cheb"))):
        for name in names:
            spy(mod, name, masked=True)
    try:
        yield calls
    finally:
        monkeypatch.undo()


def _apply(op, pop, x, kw):
    """``op`` through the PartitionedOp's own operation."""
    if op == "residual":
        return pop.residual(x, kw["b"])
    if op == "add":
        return pop.add(x, kw["z"])
    d = None if kw["d"] is None else kw["d"].clone()
    return pop.cheb(kw["dinv"], kw["b"], kw["x"], d, kw["c1"], kw["c2"], kw["keep_d"])


# square operators: every op on a SlicedEll and a SlicedDiag interior; U0
# (rectangular, a transfer, so SlicedEll as the halo path lays it out): add
PARTITIONED = [(op, layout) for op in ("cheb_first", "cheb_next", "jacobi", "residual")
               for layout in ("sliced", "sdiag")] + [("add", "sliced")]


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("op,layout", PARTITIONED)
def test_partitioned_operation_bitwise_equals_plain_composition(
        torus, monkeypatch, op, layout, D, dtype, d):
    """Each operation of a PartitionedOp equals the plain composition
    ``epilogue_plain(mode, op(x), ...)`` bit for bit, and runs as a masked
    interior call and one ``halo_spmv_<mode>`` call."""
    t_dt = DTYPES[dtype]
    pop = _op(torus, "U" if op == "add" else "A", D, t_dt, layout)
    rng = np.random.default_rng(D)
    x = _vec(rng, pop.A.ncols, d, t_dt)
    kw = _operands(op, pop.A.nrows, d, t_dt, seed=7)
    if MODE[op] == "cheb":
        x = kw["x"]
    want = epilogue_plain(MODE[op], pop(x), **kw)
    with _spies(monkeypatch) as calls:
        got = _apply(op, pop, x, kw)
    _equal(got, want)
    halo_name = f"halo_spmv_{MODE[op]}"
    interior = {"residual": "residual", "add": "add"}.get(op, "cheb")
    prefix = "sliced_diag_spmv" if layout == "sdiag" else "sliced_spmv"
    assert calls == {halo_name: 1, f"{prefix}_{interior}": 1}, calls


HALO_OPS = ["cheb_first", "cheb_next", "jacobi", "residual", "add"]


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op", HALO_OPS)
def test_halo_mode_plain_equals_add_then_epilogue(torus, op, dtype, d):
    """``halo_spmv_<mode>`` on the CPU: the halo sum added into y at
    out_row, then the epilogue there; held against the epilogue computed
    on every row after the add and taken at out_row.  The other rows of
    y (and of d) are untouched."""
    t_dt = DTYPES[dtype]
    pop = _op(torus, "U" if op == "add" else "A", 4, t_dt)
    Ah, rows = pop.Ah, pop.out_row.long()
    n = pop.A.nrows
    rng = np.random.default_rng(3)
    hb = _vec(rng, Ah.ncols, d, t_dt)
    y0 = _vec(rng, n, d, t_dt)
    kw = _operands(op, n, d, t_dt, seed=8)
    if MODE[op] == "cheb" and kw["keep_d"] and kw["d"] is None:
        kw["d"] = _vec(rng, n, d, t_dt, 0.1)      # the interior's step buffer
    added = y0.clone()
    added[rows] = added[rows] + slmod.sliced_spmv_plain(Ah.slice_ptr, Ah.col, Ah.val,
                                                        hb, Ah.nrows)
    args = (Ah.slice_ptr, Ah.col, Ah.val, pop.out_row, hb, y0.clone())
    keep = torch.zeros(n, dtype=torch.bool)
    keep[rows] = True
    keep = keep[:, None] if d == 3 else keep
    if MODE[op] != "cheb":
        full = epilogue_plain(MODE[op], added, **kw)
        fn = hmod.halo_spmv_residual if op == "residual" else hmod.halo_spmv_add
        got = fn(*args, kw["b" if op == "residual" else "z"], Ah.tpr)
        _equal(got, torch.where(keep, full, y0))
        return
    d_in = None if kw["d"] is None else kw["d"].clone()
    x_full, d_full = epilogue_plain(
        "cheb", added, b=kw["b"], dinv=kw["dinv"], x=kw["x"],
        d=kw["d"] if kw["c1"] is not None else None, c1=kw["c1"], c2=C2)
    y, d_out = hmod.halo_spmv_cheb(*args, kw["x"], kw["b"], kw["dinv"], d_in,
                                   kw["c1"], C2, Ah.tpr)
    _equal(y, torch.where(keep, x_full, y0))
    if kw["keep_d"]:
        assert d_out is d_in
        _equal(d_out, torch.where(keep, d_full, kw["d"]))
    else:
        assert d_out is None


MASKED = [(op, "sliced") for op in HALO_OPS] + [
    (op, "sdiag") for op in HALO_OPS if op != "add"]


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("op,layout", MASKED)
def test_masked_interior_plain(torus, op, layout, dtype, d):
    """The masked interior launch's plain version (a ``row_mask`` on the
    sliced wrappers): the full epilogue on the rows whose bit is clear,
    the raw sum on the boundary rows, where a Chebyshev step leaves d as
    it was (zero on a first step)."""
    t_dt = DTYPES[dtype]
    pop = _op(torus, "U" if op == "add" else "A", 4, t_dt, layout)
    A, mask = pop.A, pop.row_mask
    rng = np.random.default_rng(5)
    x = _vec(rng, A.ncols, d, t_dt)
    kw = _operands(op, A.nrows, d, t_dt, seed=9)
    if MODE[op] == "cheb":
        x = kw.pop("x")
    if layout == "sdiag":
        args = (A.slice_ptr, A.base, A.delta, A.val, A.wide_ptr, A.wide_col, x)
        y = sdmod.sliced_diag_spmv_plain(*args, A.nrows)
        residual, cheb = sdmod.sliced_diag_spmv_residual, sdmod.sliced_diag_spmv_cheb
        tail = (A.nrows,)
    else:
        args = (A.slice_ptr, A.col, A.val, x)
        y = slmod.sliced_spmv_plain(*args, A.nrows)
        residual, cheb = slmod.sliced_spmv_residual, slmod.sliced_spmv_cheb
        tail = (A.nrows, A.tpr)
    m = masked_rows(mask, A.nrows)
    assert m.sum() == pop.Ah.nrows
    m = m[:, None] if d == 3 else m
    if op == "residual":
        got = residual(*args, kw["b"], *tail, row_mask=mask)
        return _equal(got, torch.where(m, y, kw["b"] - y))
    if op == "add":
        got = slmod.sliced_spmv_add(*args, kw["z"], *tail, row_mask=mask)
        return _equal(got, torch.where(m, y, kw["z"] + y))
    d_in = None if kw["d"] is None else kw["d"].clone()
    x_out, d_out = cheb(*args, kw["b"], kw["dinv"], d_in, kw["c1"], C2, *tail,
                        keep_d=kw["keep_d"], row_mask=mask)
    full_x, full_d = epilogue_plain("cheb", y, x=x, **kw)
    _equal(x_out, torch.where(m, y, full_x))
    if not kw["keep_d"]:
        assert d_out is None
    else:
        kept = torch.zeros_like(y) if kw["d"] is None else kw["d"]
        _equal(d_out, torch.where(m, kept, full_d))


@pytest.mark.parametrize("D", [2, 4])
def test_row_mask_marks_the_boundary_rows(torus, D):
    """The row mask holds one int32 word per 32-row slice of the interior,
    with exactly the halo part's out_row set (bit 31 included, where the
    word reads negative)."""
    pop = _op(torus, "A", D, torch.float32)
    mask = pop.row_mask
    assert mask.dtype == torch.int32 and mask.shape == (-(-pop.A.nrows // 32),)
    rows = torch.nonzero(masked_rows(mask, pop.A.nrows))[:, 0]
    assert torch.equal(rows, pop.out_row.long())
    assert torch.equal(row_mask_from_rows(np.array([0, 31, 33, 95]), 100),
                       torch.tensor([1 - 2**31, 2, -2**31, 0], dtype=torch.int32))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_partitioned_op_takes_its_own_route(torus, monkeypatch, dtype):
    """``sparse.cheb_step``, ``spmv_residual`` and ``ShuffleTransfer.
    prolong_add`` send a PartitionedOp to its own operations (the masked
    interior and ``halo_spmv`` in the same mode), and stay bitwise equal
    to the cycle's inline torch expressions over ``op(x)``."""
    t_dt = DTYPES[dtype]
    A = _op(torus, "A", 2, t_dt)
    U = sparse.ShuffleTransfer(_op(torus, "U", 2, t_dt), _op(torus, "UT", 2, t_dt))
    n = A.A.nrows
    rng = np.random.default_rng(9)
    for d in (1, 3):
        b, x, e = (_vec(rng, rows, d, t_dt) for rows in (n, n, U.U.A.ncols))
        d_prev = _vec(rng, n, d, t_dt, 0.1)
        dinv = torch.from_numpy(0.5 + rng.random(n)).to(t_dt)
        dv = dinv[:, None] if d == 3 else dinv
        y = A(x)
        step = C2 * dv * (b - y)
        inline = {"cheb_first": (x + step, step),
                  "cheb_next": (x + (C1 * d_prev + step), C1 * d_prev + step),
                  "jacobi": x + step, "residual": b - y, "add": x + U.prolong(e)}
        with _spies(monkeypatch) as calls:
            ported = {
                "cheb_first": sparse.cheb_step(A, dinv, b, x, None, None, C2),
                "cheb_next": sparse.cheb_step(A, dinv, b, x, d_prev.clone(), C1, C2),
                "jacobi": sparse.cheb_step(A, dinv, b, x, None, None, C2,
                                           keep_d=False)[0],
                "residual": sparse.spmv_residual(A, x, b),
                "add": U.prolong_add(e, x)}
        for case, want in inline.items():
            _equal(ported[case], want)
        assert calls == {"halo_spmv_cheb": 3, "sliced_spmv_cheb": 3,
                         "halo_spmv_residual": 1, "sliced_spmv_residual": 1,
                         "halo_spmv_add": 1, "sliced_spmv_add": 1}, calls


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("criteria", [0, 1, 2, 3])
def test_residual_numerator_bitwise_unchanged(torus, dtype, criteria):
    """``HaloContext._residual_num_sq`` forms ``b - A x`` through the
    residual operation; the numerators equal those of the ``A x - b`` it
    formed before bit for bit (negation is exact, every criterion even)."""
    t_dt = DTYPES[dtype]
    ctx = mg.MultigridSolveContext(torus["solver"].hierarchy, torus["lhs"], torus["M"],
                                   mg.SolverConfig(), dtype=t_dt, device="cpu",
                                   diag_min_groups=4)
    hctx = halo.HaloContext(ctx, halo.make_solver_mesh(4, "cpu"))
    rng = np.random.default_rng(criteria)
    b = hctx._local_vec(rng.standard_normal((ctx.chain_csr[0].shape[0], 2)), 0)
    x = hctx._local_vec(rng.standard_normal((ctx.chain_csr[0].shape[0], 2)), 0)
    got = hctx._residual_num_sq(b, x, criteria)
    r = sparse.spmv(hctx.levels[0].A, x) - b
    want = [(r * r).sum(0), (r * (hctx._minv[:, None] * r)).sum(0),
            (r * sparse.spmv(hctx.M, r)).sum(0), (r * r).sum(0)][criteria]
    _equal(got, want)


def _fused_trace(hctx):
    (loop,) = hctx._fused.values()
    return loop.state.trace[: hctx.dispatched].tolist()


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("mode", ["fused", "traced"])
def test_halo_solve_bitwise_equals_plain_compositions(torus, monkeypatch, mode, d):
    """A whole halo solve on 4 partitions through the fused operations
    against the same solve with ``chip_smoke.plain_compositions`` patched
    in (every operation the SpMV followed by its torch ops): x, cycles,
    residual and, fused, the loop's trace bit for bit; the fused solve
    reaches every halo_spmv mode, the patched one none."""
    from chip_smoke import plain_compositions

    ctx = torus["ctx"]
    n = ctx.chain_csr[0].shape[0]
    rhs = torus["M"] @ np.random.default_rng(d).standard_normal((n, d))
    rhs = rhs[:, 0] if d == 1 else rhs
    hctx = halo.HaloContext(ctx, halo.make_solver_mesh(4, "cpu"))
    runs = {}
    for how in ("epilogues", "plain"):
        hctx.release_graphs()
        with plain_compositions() if how == "plain" else contextlib.nullcontext(), \
                _spies(monkeypatch) as calls:
            x, iters, res = hctx.solve(rhs, tol=1e-5, max_iter=50, mode=mode)
            runs[how] = (x, iters, res,
                         _fused_trace(hctx) if mode == "fused" else None, dict(calls))
    (x, iters, res, trace, calls), p = runs["epilogues"], runs["plain"]
    assert np.array_equal(x, p[0]) and iters == p[1] and res == p[2] and trace == p[3]
    assert iters > 1 and res <= 1e-5
    assert all(calls.get(f"halo_spmv_{m}", 0) > 0 for m in ("residual", "add", "cheb"))
    assert not any(k.startswith("halo_spmv_") for k in p[4]), p[4]
    assert p[4]["halo_spmv"] > 0
    assert torus["solver"].residual(torus["lhs"], rhs, x) <= 2e-5


def test_halo_solve_matches_reference(sphere_mesh, monkeypatch):
    """The JAX HaloContext on 4 devices and the port's on 4 partitions,
    same hierarchy and rhs, the port through the fused operations: equal
    cycles, residuals within 5%, f32 solutions within 1e-4 of max|x| (the
    bounds of test_halo_context_matches_reference)."""
    V, M, S = sphere_mesh["V"], sphere_mesh["M"], sphere_mesh["S"]
    lhs = (M + 1e-3 * S).tocsr()
    rhs = M @ np.random.default_rng(0).standard_normal(V.shape[0])
    ref = RefSolver(V, sphere_mesh["neigh"], M, lower_bound=100)
    x_ref, it_ref, res_ref = ref_halo.HaloContext(
        ref._context(lhs), ref_mesh(4)).solve(rhs, tol=1e-5, max_iter=50)
    ctx = mg.MultigridSolveContext(
        convert.hierarchy_from_reference(ref.hierarchy), lhs, M, mg.SolverConfig(),
        device="cpu")
    with _spies(monkeypatch) as calls:
        x, it, res = halo.HaloContext(ctx, halo.make_solver_mesh(4, "cpu")).solve(
            rhs, tol=1e-5, max_iter=50)
    assert all(calls.get(f"halo_spmv_{m}", 0) > 0 for m in ("residual", "add", "cheb"))
    assert it == it_ref, (it, it_ref)
    assert res <= 1e-5 and abs(res - res_ref) <= 0.05 * res_ref
    assert np.abs(x - x_ref).max() / np.abs(x_ref).max() < 1e-4
