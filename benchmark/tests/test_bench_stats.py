"""The end-to-end statistics: a rate over the whole window and the p95 over
every call."""

import statistics

import pytest

from benchmark.harness import load_reader
from benchmark.record import Call, Run, p95, rate


def _run(walls, window_s, kind="solve", profiled=0):
    calls = [Call(w, {}, 5, i < profiled) for i, w in enumerate(walls)]
    return Run(kind=kind, setup_s=12.5, window_s=window_s, calls=calls,
               hierarchy_timing={}, context_timing={})


def test_rate_counts_every_call_over_the_whole_window():
    run = _run([40.0] * 250, 10.0)
    assert load_reader("solves_per_s")(run) == pytest.approx(25.0)
    assert rate(0, 10.0) is None


def test_p95_is_taken_over_all_calls_with_the_tail_in_it():
    walls = [10.0] * 95 + [100.0] * 5
    run = _run(walls, 2.0)
    want = statistics.quantiles(walls, n=100, method="inclusive")[94]
    assert load_reader("solve_ms_p95")(run) == pytest.approx(want)
    assert p95(range(1, 101)) == pytest.approx(95.05)


def test_the_per_layer_p95_leaves_out_profiled_calls():
    walls = [200.0] * 10 + [10.0] * 95 + [100.0] * 5
    run = _run(walls, 2.0, profiled=10)
    want = statistics.quantiles(walls[10:], n=100, method="inclusive")[94]
    assert load_reader("solve_ms_p95.fused")(run) == pytest.approx(want)


def test_flow_step_ms_is_the_window_over_the_steps():
    run = _run([500.0] * 40, 20.0, kind="flow")
    assert load_reader("flow_step_ms")(run) == pytest.approx(500.0)
    assert load_reader("solves_per_s")(run) is None


@pytest.mark.parametrize("name", ["facade_ms", "loop_ms", "cycles_per_solve"])
def test_host_span_means_leave_out_profiled_calls(name):
    calls = [Call(50.0, {"solve_upload": 1.0, "cycles": 4.0, "iterations": 5.0},
                  6, False),
             Call(90.0, {"solve_upload": 2.0, "cycles": 40.0, "iterations": 9.0},
                  10, True)]
    run = Run("solve", 1.0, 1.0, calls, {}, {})
    want = {"facade_ms": 45.0, "loop_ms": 4.0, "cycles_per_solve": 5.0}[name]
    assert load_reader(name)(run) == pytest.approx(want)
