"""The cycle's operations around an SpMV (``ops/epilogue.py``): the
residual ``b - A x``, the prolongation's ``x + U e`` and a Chebyshev or
Jacobi step, which the card computes as one SpMV launch with an epilogue
(``sparse.spmv_residual``, ``spmv_add``, ``cheb_step``).

On the CPU each runs its plain version, the torch ops after the plain
SpMV.  Three tests:

* each operation against the JAX package (its smoothers,
  ``b - spmv(A, x)`` and ``x + U.prolong(e)``) on the reference
  hierarchy's operators, laid out as SlicedDiag and as SlicedEll, f32 and
  f64, d = 1 and 3: within 1e-6 of max|y| in f32 and 1e-12 in f64 (the
  SpMVs sum in other orders);
* each operation bitwise equal to the inline torch expressions it
  replaces in the cycle: this fixes the operation order
  (``c2 * dinv`` first, then ``* r``, ``c1 * d``, their sum, ``x + d``)
  that the kernels' epilogues reproduce on the card;
* the dispatch by type: the gather-based ``Prolongation``, the JAX
  layouts and ``EllMatrix`` take the plain composition over ``spmv``,
  bitwise equal to those expressions, and never reach the sliced
  wrappers (the halo path's ``PartitionedOp`` takes its own route:
  ``tests/test_torch_halo_epilogue.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gravo_mg_tpu import sparse as ref_sparse
from gravo_mg_tpu.hierarchy.builder import build_hierarchy as ref_build
from gravo_mg_tpu.solver import multigrid as ref_mg
from gravo_mg_tpu.solver import smoothers as ref_smoothers
from gravo_mg_tpu_torch import convert, sparse
from gravo_mg_tpu_torch.ops import sliced_diag_spmv as sdmod
from gravo_mg_tpu_torch.ops import sliced_spmv as slmod
from gravo_mg_tpu_torch.solver import residual, smoothers

torch.set_num_threads(2)

DTYPES = {"f32": (np.float32, torch.float32, 1e-6),
          "f64": (np.float64, torch.float64, 1e-12)}
LAYOUTS = {"sdiag": sparse.sliced_diag_from_scipy, "sliced": sparse.sliced_from_scipy}


@pytest.fixture(scope="module")
def contexts(sphere_mesh):
    """The JAX package's context (f32 and f64) on the 2562-vertex sphere,
    lhs M + 1e-3 S, a hierarchy of lower_bound 100."""
    h = ref_build(sphere_mesh["V"], sphere_mesh["neigh"], lower_bound=100)
    lhs = (sphere_mesh["M"] + 1e-3 * sphere_mesh["S"]).tocsr()
    return {name: ref_mg.MultigridSolveContext(h, lhs, sphere_mesh["M"],
                                               ref_mg.SolverConfig(),
                                               dtype=jnp.dtype(np_dt))
            for name, (np_dt, _, _) in DTYPES.items()}


def _vec(n, d, np_dt, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n,) if d == 1 else (n, d)).astype(np_dt)


def _close(got, ref, tol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-30), err


OPERATIONS = ["cheb1", "cheb2", "cheb3", "cheb4", "jacobi", "residual", "add"]


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("op", OPERATIONS)
def test_operation_matches_reference(contexts, op, layout, dtype, d):
    """Each operation's plain version against the JAX package: the finest
    level's A (and U0 for the add) as ``layout``."""
    np_dt, t_dt, tol = DTYPES[dtype]
    ctx = contexts[dtype]
    lvl = ctx.levels[0]
    if op == "add":
        U = ctx.U_csr[0]
        e = _vec(U.shape[1], d, np_dt, 1)
        x = _vec(U.shape[0], d, np_dt, 2)
        ref = x + np.asarray(lvl.U.prolong(jnp.asarray(e)))
        got = sparse.spmv_add(LAYOUTS[layout](U, dtype=t_dt), torch.from_numpy(e),
                              torch.from_numpy(x))
        return _close(got.numpy(), ref, tol)
    A = LAYOUTS[layout](ctx.chain_csr[0], dtype=t_dt)
    n = A.nrows
    b, x = _vec(n, d, np_dt, 3), _vec(n, d, np_dt, 4)
    tb, tx = torch.from_numpy(b), torch.from_numpy(x)
    dinv = np.asarray(lvl.diag_inv)
    tdinv = torch.from_numpy(dinv)
    lam_max = float(np.asarray(lvl.lam_max))
    lam_min, lam_max = lam_max / 12.0, 1.1 * lam_max
    if op == "residual":
        ref = b - np.asarray(ref_sparse.spmv(lvl.A, jnp.asarray(x)))
        got = sparse.spmv_residual(A, tx, tb)
    elif op == "jacobi":
        ref = np.asarray(ref_smoothers.jacobi(lvl.A, lvl.diag_inv, jnp.asarray(b),
                                              jnp.asarray(x), 2))
        got = smoothers.jacobi(A, tdinv, tb, tx, 2)
    else:
        degree = int(op[-1])
        ref = np.asarray(ref_smoothers.chebyshev(lvl.A, lvl.diag_inv, jnp.asarray(b),
                                                 jnp.asarray(x), degree, lam_min,
                                                 lam_max))
        got = smoothers.chebyshev(A, tdinv, tb, tx, degree, lam_min, lam_max)
    _close(got.numpy(), ref, tol)


# The inline torch expressions each operation replaces in the cycle.
def _inline(case, A, U, b, x, e, dinv, d_prev, c1, c2):
    dv = dinv[:, None] if b.ndim == 2 else dinv
    if case == "cheb_first":
        d = c2 * dv * (b - sparse.spmv(A, x))
        return x + d, d
    if case == "cheb_next":
        r = b - sparse.spmv(A, x)
        d = c1 * d_prev + c2 * dv * r
        return x + d, d
    if case == "jacobi":
        return x + c2 * dv * (b - sparse.spmv(A, x))
    if case == "residual":
        return b - sparse.spmv(A, x)
    if case == "add":
        return x + U.prolong(e)
    if case == "smoother":
        theta, delta = 0.5 * (c1 + c2), 0.5 * (c2 - c1)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = (1.0 / theta) * dv * (b - sparse.spmv(A, x))
        x = x + d
        for _ in range(3):
            rho_new = 1.0 / (2.0 * sigma - rho)
            r = b - sparse.spmv(A, x)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * dv * r
            x = x + d
            rho = rho_new
        return x
    raise ValueError(case)


def _ported(case, A, U, b, x, e, dinv, d_prev, c1, c2):
    if case == "cheb_first":
        return sparse.cheb_step(A, dinv, b, x, None, None, c2)
    if case == "cheb_next":
        return sparse.cheb_step(A, dinv, b, x, d_prev.clone(), c1, c2)
    if case == "jacobi":
        x_out, d = sparse.cheb_step(A, dinv, b, x, None, None, c2, keep_d=False)
        assert d is None
        return x_out
    if case == "residual":
        return sparse.spmv_residual(A, x, b)
    if case == "add":
        return U.prolong_add(e, x)
    if case == "smoother":
        return smoothers.chebyshev(A, dinv, b, x, 4, c1, c2)
    raise ValueError(case)


CASES = ["cheb_first", "cheb_next", "jacobi", "residual", "add", "smoother",
         "numerator"]


def _inputs(A, U, d, t_dt, seed=5):
    n = A.shape[0]
    rng = np.random.default_rng(seed)

    def v(m, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal((m,) if d == 1 else (m, d))
                                ).to(t_dt)

    dinv = torch.from_numpy(0.5 + rng.random(n)).to(t_dt)
    return dict(b=v(n), x=v(n), e=v(U.ncoarse), dinv=dinv, d_prev=v(n, 0.1),
                c1=0.3717, c2=0.8391)


def _assert_bitwise(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _sphere_level(contexts, dtype):
    """The finest level's A and U0 of the sphere as csr (f64 values)."""
    ctx = contexts[dtype]
    return ctx.chain_csr[0], ctx.U_csr[0]


@pytest.mark.parametrize("d", [1, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("case", CASES)
def test_operation_bitwise_equals_inline_expression(contexts, case, layout, dtype,
                                                   d):
    """On the CPU, ``cheb_step``, ``spmv_residual``, ``prolong_add`` (and
    the smoother and residual numerators built on them) equal the cycle's
    inline torch expressions they replace bit for bit."""
    _, t_dt, _ = DTYPES[dtype]
    A_csr, U_csr = _sphere_level(contexts, dtype)
    A = LAYOUTS[layout](A_csr, dtype=t_dt)
    U = sparse.ShuffleTransfer(LAYOUTS[layout](U_csr, dtype=t_dt),
                               sparse.sliced_from_scipy(U_csr.T.tocsr(), dtype=t_dt))
    kw = _inputs(A, U, d, t_dt)
    if case == "numerator":
        # the inline numerator forms A x - b: its exact negation
        M = sparse.sliced_from_scipy(A_csr, dtype=t_dt)
        minv = 1.0 / kw["dinv"]
        for criteria in range(4):
            got = residual.residual_numerator(A, M, minv, kw["b"], kw["x"], criteria)
            r = sparse.spmv(A, kw["x"]) - kw["b"]
            r = r[:, None] if r.ndim == 1 else r
            want = [torch.linalg.vector_norm(r, dim=0),
                    torch.sqrt(torch.sum(r * (minv[:, None] * r), dim=0)),
                    torch.sqrt(torch.sum(r * sparse.spmv(M, r), dim=0)),
                    torch.linalg.vector_norm(r).reshape(1)][criteria]
            _assert_bitwise(got, want)
        return
    if case == "smoother":
        kw.update(c1=0.05, c2=1.9)       # the band [lam_min, lam_max]
    _assert_bitwise(_ported(case, A, U, **kw), _inline(case, A, U, **kw))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["prolongation", "reference", "ell"])
def test_dispatch_by_type_takes_plain_composition(contexts, monkeypatch, kind, dtype):
    """Operators other than SlicedEll, SlicedDiag and PartitionedOp take
    the plain composition over ``spmv``, bitwise equal to the inline
    expressions, and the sliced wrappers are never called for them."""
    _, t_dt, _ = DTYPES[dtype]
    for mod, names in ((slmod, ("sliced_spmv_residual", "sliced_spmv_add",
                                "sliced_spmv_cheb")),
                       (sdmod, ("sliced_diag_spmv_residual",
                                "sliced_diag_spmv_cheb"))):
        for name in names:
            def refuse(*args, _name=name, **kw):
                raise AssertionError(f"{_name} called for a {kind} operator")
            monkeypatch.setattr(mod, name, refuse)
    ctx = contexts[dtype]
    A_csr, U_csr = _sphere_level(contexts, dtype)
    if kind == "prolongation":
        A = sparse.ell_from_scipy(A_csr, dtype=t_dt)
        U = sparse.make_prolongation(*_prolongation_arrays(U_csr), U_csr.shape[1],
                                     dtype=t_dt)
        e_rows = U.ncoarse
    elif kind == "reference":          # the JAX package's layouts, converted
        lvl = ctx.levels[0]
        A = convert.operator_from_reference(lvl.A)
        U = convert.transfer_from_reference(lvl.U)
        assert isinstance(A, (sparse.DiagEll, sparse.ShuffleEll, sparse.EllMatrix))
        e_rows = U.ncoarse
    else:
        A = sparse.ell_from_scipy(A_csr, dtype=t_dt)
        U = sparse.ShuffleTransfer(sparse.ell_from_scipy(U_csr, dtype=t_dt),
                                   sparse.ell_from_scipy(U_csr.T.tocsr(), dtype=t_dt))
        e_rows = U_csr.shape[1]
    n = A.shape[0]
    rng = np.random.default_rng(9)
    for d in (1, 3):
        def v(m):
            return torch.from_numpy(rng.standard_normal((m,) if d == 1 else (m, d))
                                    ).to(t_dt)
        kw = dict(b=v(n), x=v(n), e=v(e_rows), d_prev=0.1 * v(n),
                  dinv=torch.from_numpy(0.5 + rng.random(n)).to(t_dt),
                  c1=0.3717, c2=0.8391)
        for case in ("cheb_first", "cheb_next", "jacobi", "residual", "add"):
            _assert_bitwise(_ported(case, A, U, **kw), _inline(case, A, U, **kw))


def _prolongation_arrays(U_csr):
    """U0 as the fixed-width (Nf, W) cols/weights of a Prolongation."""
    U = U_csr.tocsr()
    w = int(np.diff(U.indptr).max())
    nf = U.shape[0]
    cols = np.zeros((nf, w), np.int32)
    wts = np.zeros((nf, w), np.float64)
    for i in range(nf):
        lo, hi = U.indptr[i], U.indptr[i + 1]
        cols[i, : hi - lo] = U.indices[lo:hi]
        wts[i, : hi - lo] = U.data[lo:hi]
    return cols, wts
