"""The port's spans: per-call host milliseconds in ``solver_timing``, and
the host-only ones as ranges on a recording ``torch.profiler``'s timeline.

On the CPU: every span of the facade, the solve and the flow step is set
by the call that runs its step and by no other; ``solver_total`` is this
solve's own spans (plus the set-up where the call refreshed the values);
the spans fit inside the call, one after another on each thread where
the compares ran beside the solve; only the spans that launch no device work
appear on the profiler's timeline; the benchmark's readers of the spans
give numbers on a tiny run of each cell.  On the card (marked ``cuda``,
skipped without a GPU): ``loop_device`` lies inside ``cycles``, and no
program span is an event on the device timeline.
"""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gravo_mg_tpu_torch import MultigridSolver
from gravo_mg_tpu_torch.models import ConformalFlow
from gravo_mg_tpu_torch.utils import profiler
from gravo_mg_tpu_torch.utils.laplacian import cotan_laplacian, mass_voronoi
from gravo_mg_tpu_torch.utils.meshgen import icosphere
from gravo_mg_tpu_torch.utils.neighbors import neighbors_from_faces
from gravo_mg_tpu_torch.utils.profiler import span

torch.set_num_threads(2)

MODES = ["traced", "fused"]
# spans set by every solve through the facade
SOLVE_KEYS = ("facade_pattern_key", "solve_upload", "solve_deflation",
              "cycles", "solve_copy_back", "solver_total")
# program spans that enclose no device work: ranges on the profiler timeline
TIMELINE = ("facade_pattern_key", "facade_value_compare", "solve_deflation",
            "update_galerkin", "update_spectral", "update_coarse_factor",
            "flow_mass", "flow_assembly", "flow_normalize")
# program spans that enclose device work or read the device clock
OFF_TIMELINE = ("solve_upload", "cycles", "solve_copy_back", "loop_device",
                "plan_build", "reduction", "setup_coarse_factor")


@pytest.fixture(scope="module")
def sphere():
    V, F = icosphere(3, bump=0.1)
    S, M = cotan_laplacian(V, F), mass_voronoi(V, F)
    return V, F, S, M, neighbors_from_faces(F)


def _solver(sphere, device="cpu"):
    V, F, S, M, neigh = sphere
    return MultigridSolver(V, neigh, M, lower_bound=100, device=device)


def _host_names(prof) -> set:
    return {e.name for e in prof.events()
            if getattr(e.device_type, "name", "") != "CUDA"}


def test_span_stores_the_block_and_leaves_the_timeline_alone():
    t = {"k": 5.0}
    with span(t, "k", host_only=True) as s:
        time.sleep(0.002)
    assert t["k"] >= 1.5 and s.t0 > 0
    with span(None, "nothing", host_only=True):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span(t, "shown", host_only=True):
            pass
        with span(t, "hidden", host_only=False):
            pass
    names = _host_names(prof)
    assert "shown" in names and "hidden" not in names
    assert set(t) == {"k", "shown", "hidden"}


@pytest.mark.parametrize("mode", MODES)
def test_solve_spans_describe_this_call(sphere, mode):
    V, F, S, M, neigh = sphere
    solver = _solver(sphere)
    lhs, rhs = (M + 1e-3 * S).tocsr(), M @ V

    def solved(lhs):
        solver.solve(lhs, rhs, mode=mode)
        t = solver.solver_timing
        assert all(t[k] >= 0 for k in SOLVE_KEYS), t
        assert "loop_device" not in t          # the device clock, card only
        own = t["solve_upload"] + t["cycles"] + t["solve_copy_back"]
        return t, own

    t, own = solved(lhs)                       # builds the context
    assert "facade_value_compare" not in t
    assert t["solver_total"] == pytest.approx(own + t["plan_build"] + t["reduction"])
    t, own = solved(lhs)                       # same values: no set-up
    assert t["facade_value_compare"] >= 0
    assert t["solver_total"] == pytest.approx(own)
    lhs = (M + 2e-3 * S).tocsr()
    t, own = solved(lhs)                       # new values: update_lhs
    assert t["solver_total"] == pytest.approx(own + t["plan_build"] + t["reduction"])
    t, own = solved(lhs)
    assert t["solver_total"] == pytest.approx(own)


def test_residual_leaves_the_solve_timing(sphere):
    V, F, S, M, neigh = sphere
    solver = _solver(sphere)
    lhs, rhs = (M + 1e-3 * S).tocsr(), M @ V
    x = solver.solve(lhs, rhs)
    before = dict(solver.solver_timing)
    solver.residual(lhs, rhs, x)
    assert solver.solver_timing == before


@pytest.mark.parametrize("mode", MODES)
def test_spans_fit_inside_the_call(sphere, mode):
    V, F, S, M, neigh = sphere
    solver = _solver(sphere)
    lhs, rhs = (M + 1e-3 * S).tocsr(), M @ V
    solver.solve(lhs, rhs, mode=mode)
    for _ in range(3):
        t0 = time.perf_counter()
        solver.solve(lhs, rhs, mode=mode)
        wall = (time.perf_counter() - t0) * 1000
        t = solver.solver_timing
        compares = t["facade_pattern_key"] + t["facade_value_compare"]
        solve = t["solve_upload"] + t["cycles"] + t["solve_copy_back"]
        if t["facade_ran_ahead"]:
            # the compares ran on the pool beside the solve, and the caller
            # waited for what was left of them after it
            assert 0 < compares <= wall
            assert 0 < solve + t["facade_compare_wait"] <= wall
        else:
            assert 0 < compares + solve <= wall
        assert t["solve_deflation"] <= t["solve_upload"]


def test_flow_step_leaves_its_spans(sphere):
    V, F, *_ = sphere
    flow = ConformalFlow(V, F, tau=5e-3, lower_bound=80, device="cpu")
    for step in range(2):
        t0 = time.perf_counter()
        flow.step()
        wall = (time.perf_counter() - t0) * 1000
        t = flow.solver.solver_timing
        spans = [t[k] for k in ("flow_mass", "flow_assembly", "flow_normalize")]
        assert all(v >= 0 for v in spans)
        assert sum(spans) + t["solver_total"] <= wall
        # the first step builds the context, every later one refreshes it
        assert ("facade_value_compare" in t) == (step > 0)


def test_host_spans_on_the_profiler_timeline(sphere, monkeypatch):
    """Under a CPU profiler session the host-only spans are ranges of their
    names and the others are not; with no session no range is opened."""
    V, F, *_ = sphere
    flow = ConformalFlow(V, F, tau=5e-3, lower_bound=80, device="cpu")
    flow.step()                               # builds the context
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        flow.step()                           # compares, then update_lhs
    names = _host_names(prof)
    assert set(TIMELINE) <= names, set(TIMELINE) - names
    assert not names & set(OFF_TIMELINE), names & set(OFF_TIMELINE)

    opened = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: opened.append(name) or real(name))
    flow.step()
    assert opened == []
    assert all(k in flow.solver.solver_timing for k in ("flow_mass", "cycles"))
    with profile(activities=[ProfilerActivity.CPU]):
        flow.step()
    assert set(opened) >= {"flow_mass", "update_galerkin"}


@pytest.mark.parametrize("cell,metrics,silent", [
    ("poisson1m.fused", ("pattern_key_ms", "value_compare_ms", "copy_back_ms"),
     ("loop_device_ms",)),
    ("smooth262k.rhs3", ("pattern_key_ms", "value_compare_ms", "copy_back_ms"),
     ("loop_device_ms",)),
    ("smooth262k.flow", ("flow_mass_ms", "flow_assembly_ms", "flow_normalize_ms",
                         "flow_facade_ms"), ()),
])
def test_span_readers_on_a_tiny_run(tmp_path, cell, metrics, silent):
    """The benchmark's readers of the spans, on a traced tiny run of each
    cell on the CPU; the device clock's reader has nothing to read there."""
    from benchmark import harness
    from benchmark.tests.tiny import tiny_root

    root, bench = tiny_root(tmp_path)
    r = harness.run_cell(cell, 2**31 + 16, 0.3, True, device="cpu",
                         root=root, bench_dir=bench)
    assert r["correct"]
    for name in metrics:
        assert r["metrics"][name]["value"] >= 0, name
    for name in silent:
        assert name not in r["metrics"]


# ---- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def sphere5():
    V, F = icosphere(5, bump=0.1)
    S, M = cotan_laplacian(V, F), mass_voronoi(V, F)
    return V, F, S, M, neighbors_from_faces(F)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_loop_device_lies_inside_the_loop(cuda, sphere5, mode):
    V, F, S, M, neigh = sphere5
    solver = _solver(sphere5, device="cuda")
    lhs, rhs = (1e-6 * M + S).tocsr(), M @ np.random.default_rng(0).standard_normal(len(V))
    for _ in range(4):
        solver.solve(lhs, rhs, mode=mode)
        t = solver.solver_timing
        assert 0 < t["loop_device"] <= t["cycles"], t


def _kernels(prof) -> list:
    return [e.name for e in prof.events()
            if getattr(e.device_type, "name", "") == "CUDA"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["traced", "fused", "refresh"])
def test_program_spans_are_not_device_events(cuda, sphere5, monkeypatch, case):
    """A profiled warm solve (and one that refreshes the values) holds no
    device event named after a program span, and as many kernels as the
    same solve with the spans' ranges left out.  CUPTI records a part of
    a conditional WHILE graph's passes, and once read 186 kernels in one
    session of a fused solve against 191 in the next, so each side takes
    the most kernels over three sessions, in turns."""
    V, F, S, M, neigh = sphere5
    solver = _solver(sphere5, device="cuda")
    mode = "fused" if case == "fused" else "traced"
    rhs = M @ np.random.default_rng(1).standard_normal((len(V), 3))
    lhs = [(M + 1e-3 * S).tocsr(), (M + 2e-3 * S).tocsr()]
    solver.solve(lhs[0], rhs, mode=mode)
    real = profiler._profiler_enabled

    def traced(emit: bool):
        # warm; under "refresh" the profiled call updates the values
        solver.solve(lhs[0], rhs, mode=mode)
        monkeypatch.setattr(profiler, "_profiler_enabled",
                            real if emit else (lambda: False))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solver.solve(lhs[case == "refresh"], rhs, mode=mode)
            torch.cuda.synchronize()
        return _host_names(prof), _kernels(prof)

    count = {True: [], False: []}
    for emit in (True, False) * 3:
        host, device = traced(emit)
        assert not set(device) & (set(TIMELINE) | set(OFF_TIMELINE))
        if emit:
            # a call that ran ahead compared on the pool, which the session
            # does not record, and waited for it on the caller's thread
            compares = ("facade_compare_wait"
                        if solver.solver_timing["facade_ran_ahead"]
                        else "facade_pattern_key")
            assert {compares, "solve_deflation"} <= host
            assert ("update_galerkin" in host) == (case == "refresh")
        else:
            assert not host & {*TIMELINE, "facade_compare_wait"}
        count[emit].append(sum(not n.startswith(("Memcpy", "Memset")) for n in device))
    assert max(count[True]) == max(count[False]) > 0, count
