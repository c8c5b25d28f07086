"""The facade's run-ahead: a fused repeat call with the same LHS object
solves on the newest context while the compare pool compares the pattern
and the values, and keeps the answer only once both are equal.

On the CPU, in both loop modes (a traced call never runs ahead, and its
answers and counts are the same): the third fused call with one LHS object
is the first to run ahead, and its answer is bit for bit the second's; an
edit of ``lhs.data`` in place is found, the answer thrown away and the
values refreshed once, and every answer is its system's while the
interpreter switches threads as often as it can; a pattern switch in place
is thrown away and counts each stored pattern once; a new object with
equal arrays, and a flow step's new LHS, never run ahead; a solve that
raises returns only after its compares are done; the gate keeps no strong
reference to the caller's matrix.  The benchmark's readers find the
run-ahead in the fused cells only.
"""

import functools
import gc
import sys
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from gravo_mg_tpu_torch import core
from gravo_mg_tpu_torch.models import ConformalFlow

from test_torch_facade_lookup import (_absent_pairs, _close, _fresh, _solver,
                                      _with_zeros, sphere)  # noqa: F401

torch.set_num_threads(2)

MODES = ["traced", "fused"]


def _system(sphere):
    V, F, S, M, neigh = sphere
    return (M + 1e-3 * S).tocsr(), M @ V


def _ran(solver):
    t = solver.solver_timing
    return t["facade_ran_ahead"], t["facade_discarded"]


def _ahead(mode):
    """1.0 where a call in ``mode`` may run ahead: fused calls only."""
    return float(mode == "fused")


@pytest.mark.parametrize("mode", MODES)
def test_third_call_runs_ahead_with_the_second_answer(sphere, mode):
    solver, (lhs, rhs) = _solver(sphere), _system(sphere)
    xs, ran = [], []
    for _ in range(3):
        xs.append(solver.solve(lhs, rhs, mode=mode))
        ran.append(_ran(solver))
    assert ran == [(0.0, 0.0), (0.0, 0.0), (_ahead(mode), 0.0)]
    assert np.array_equal(xs[2], xs[1])
    t = solver.solver_timing
    assert t["facade_patterns_compared"] == 1
    assert t["facade_pattern_key"] >= 0 and t["facade_value_compare"] >= 0
    assert ("facade_compare_wait" in t) == bool(_ahead(mode))
    assert t["solver_total"] == pytest.approx(
        t["solve_upload"] + t["cycles"] + t["solve_copy_back"])


@pytest.mark.parametrize("mode", MODES)
def test_edit_in_place_discards_the_answer_once(sphere, mode, monkeypatch):
    solver, (lhs, rhs) = _solver(sphere), _system(sphere)
    for _ in range(2):
        x_old = solver.solve(lhs, rhs, mode=mode)
    ctx = next(iter(solver._contexts.values()))
    updates = []
    real = ctx.update_lhs
    monkeypatch.setattr(ctx, "update_lhs",
                        lambda a: updates.append(a) or real(a))
    lhs.data *= 2
    x = solver.solve(lhs, rhs, mode=mode)
    assert _ran(solver) == (_ahead(mode),) * 2 and len(updates) == 1
    assert solver.solver_timing["facade_patterns_compared"] == 1
    assert list(solver._contexts.values()) == [ctx]
    assert np.array_equal(x, _fresh(sphere, lhs, rhs, mode))
    assert not _close(x, x_old)
    # the refresh closed the gate; the call after it opens it again
    solver.solve(lhs, rhs, mode=mode)
    assert _ran(solver) == (0.0, 0.0)
    assert "facade_compare_wait" not in solver.solver_timing
    assert np.array_equal(solver.solve(lhs, rhs, mode=mode), x)
    assert _ran(solver) == (_ahead(mode), 0.0) and len(updates) == 1


@pytest.mark.parametrize("mode", MODES)
def test_edits_in_place_under_a_short_switch_interval(sphere, mode):
    """Every answer is its system's while the interpreter switches threads
    as often as it can, through edits in place and the calls after them."""
    solver, (lhs, rhs) = _solver(sphere), _system(sphere)
    base = lhs.data.copy()
    ref = {}
    for scale in (1.0, 2.0):
        np.multiply(base, scale, out=lhs.data)
        ref[scale] = _fresh(sphere, lhs, rhs, mode)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        dropped = 0.0
        for k in range(12):
            scale = 2.0 if k % 4 == 3 else 1.0
            np.multiply(base, scale, out=lhs.data)
            assert np.array_equal(solver.solve(lhs, rhs, mode=mode), ref[scale])
            dropped += solver.solver_timing["facade_discarded"]
    finally:
        sys.setswitchinterval(old)
    # each edit to 2.0 is thrown away once; an edit back follows a refresh,
    # which closes the gate
    assert dropped == 3 * _ahead(mode)


@pytest.mark.parametrize("mode", MODES)
def test_pattern_switch_in_place_is_discarded(sphere, mode):
    A, rhs = _system(sphere)
    p, q = _absent_pairs(A, 2)
    A1, A2 = _with_zeros(A, [p]), _with_zeros(A, [q])
    solver, ref = _solver(sphere), _fresh(sphere, A, rhs, mode)
    L = A1.copy()

    def load(B):
        L.indptr[:], L.indices[:], L.data[:] = B.indptr, B.indices, B.data

    # (content, ran ahead, discarded, patterns compared, contexts)
    for B, ran, dropped, compared, contexts in (
            (A1, 0, 0, 0, 1), (A1, 0, 0, 1, 1), (A2, 1, 1, 1, 2),
            (A2, 0, 0, 1, 2), (A2, 1, 0, 1, 2), (A1, 1, 1, 2, 2),
            (A1, 1, 0, 1, 2)):
        load(B)
        x = solver.solve(L, rhs, mode=mode)
        t = solver.solver_timing
        assert _ran(solver) == (ran * _ahead(mode), dropped * _ahead(mode))
        assert t["facade_patterns_compared"] == compared
        assert len(solver._contexts) == contexts
        assert _close(x, ref)


@pytest.mark.parametrize("mode", MODES)
def test_new_object_with_equal_arrays_does_not_run_ahead(sphere, mode):
    solver, (A, rhs) = _solver(sphere), _system(sphere)
    B = A.copy()
    for lhs, ran, compared in ((A, 0, 0), (A, 0, 1), (B, 0, 1), (B, 1, 1)):
        x = solver.solve(lhs, rhs, mode=mode)
        assert _ran(solver) == (ran * _ahead(mode), 0)
        assert solver.solver_timing["facade_patterns_compared"] == compared
    assert _close(x, _fresh(sphere, A, rhs, mode))


@pytest.mark.parametrize("mode", MODES)
def test_flow_steps_never_run_ahead(sphere, mode):
    V, F, *_ = sphere
    flow = ConformalFlow(V, F, tau=5e-3, lower_bound=80, device="cpu")
    flow.solver.solve = functools.partial(flow.solver.solve, mode=mode)
    for _ in range(4):
        flow.step()
        assert _ran(flow.solver) == (0.0, 0.0)
        assert "facade_compare_wait" not in flow.solver.solver_timing


@pytest.mark.parametrize("mode", MODES)
def test_a_solve_that_raises_waits_for_its_compares(sphere, mode, monkeypatch):
    solver, (lhs, rhs) = _solver(sphere), _system(sphere)
    for _ in range(2):
        solver.solve(lhs, rhs, mode=mode)
    ctx = next(iter(solver._contexts.values()))
    pool, futures, finished = solver._compare_pool, [], threading.Event()
    submit, confirm = pool.submit, core._OwnedLHS.confirm

    def recording_submit(*args, **kwargs):
        futures.append(submit(*args, **kwargs))
        return futures[-1]

    def slow_confirm(self, *args):
        time.sleep(0.3)
        out = confirm(self, *args)
        finished.set()
        return out

    def failing_solve(*args, **kwargs):
        raise RuntimeError("solve failed")

    monkeypatch.setattr(pool, "submit", recording_submit)
    monkeypatch.setattr(core._OwnedLHS, "confirm", slow_confirm)
    monkeypatch.setattr(ctx, "solve", failing_solve)
    with pytest.raises(RuntimeError, match="solve failed"):
        solver.solve(lhs, rhs, mode=mode)
    # a traced call compared before its solve, without the run-ahead's unit
    assert finished.is_set() == bool(_ahead(mode))
    assert all(f.done() for f in futures)


@pytest.mark.parametrize("mode", MODES)
def test_the_gate_holds_the_lhs_weakly(sphere, mode):
    solver, (A, rhs) = _solver(sphere), _system(sphere)
    solver.solve(A, rhs, mode=mode)           # the context keeps A
    lhs = A.copy()
    solver.solve(lhs, rhs, mode=mode)         # found with equal values
    assert solver._repeat() is lhs
    gone = weakref.ref(lhs)
    del lhs
    gc.collect()
    assert gone() is None
    solver.solve(A.copy(), rhs, mode=mode)
    assert _ran(solver) == (0.0, 0.0)


# ---- the benchmark's readers -------------------------------------------------

@pytest.mark.parametrize("cell,share,want", [
    ("poisson1m.fused", "ran_ahead_share", 100.0),
    ("smooth262k.rhs3", "ran_ahead_share", 0.0),
    ("cloud1m-f64.fused", "ran_ahead_share", 100.0),
    ("smooth262k.flow", "ran_ahead_share.flow", 0.0),
])
def test_readers_on_a_tiny_run(tmp_path, cell, share, want):
    """Every plain solve of a fused cell runs ahead, and no traced solve
    and no flow step."""
    from benchmark import harness
    from benchmark.tests.tiny import tiny_root

    root, bench = tiny_root(tmp_path)
    r = harness.run_cell(cell, 2**31 + 23, 0.3, True, device="cpu",
                         root=root, bench_dir=bench)
    assert r["correct"] and r["metrics"][share]["value"] == want
    if want:
        assert r["metrics"]["compare_wait_ms"]["value"] >= 0
    else:
        assert "compare_wait_ms" not in r["metrics"]


@pytest.mark.parametrize("kind", ["solve", "flow"])
def test_readers_read_nothing_without_the_keys(kind):
    """A program without the run-ahead (no such key in any call's timing)
    gives no number."""
    from benchmark.harness import load_reader
    from benchmark.record import Call, Run

    run = Run(kind=kind, setup_s=1.0, window_s=1.0, hierarchy_timing={},
              context_timing={},
              calls=[Call(5.0, {"facade_pattern_key": 1.0}, 5, False)])
    for name in ("compare_wait_ms", "ran_ahead_share", "ran_ahead_share.flow"):
        assert load_reader(name)(run) is None
