"""The point-cloud configuration ``poisson-cloud1m-f64`` at a tiny size, and
the readers of the layout counters and of the fused loop's roofline share.

The cell runs correct on the CPU, an altered answer does not, and a traced
run reports ``slots_per_nnz`` but no ``loop_roofline`` (the CPU has no
device clock).  ``loop_roofline`` on a recorded run reads 100% where the
loop took the least time the card's bandwidth allows for its bytes, less
where it took longer, and nothing without ``loop_device``."""

import pytest

from benchmark import harness, roofline
from benchmark.record import Call, Run
from benchmark.tests.test_bench_faults import Broken
from benchmark.tests.tiny import tiny_root

CELL = "cloud1m-f64.fused"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("cloud"))


def _run(tiny, cell, trace=False, system=None):
    root, bench = tiny
    return harness.run_cell(cell, 2**31 + 29, 0.3, trace, device="cpu",
                            system=system, root=root, bench_dir=bench)


def test_the_configuration_is_the_point_cloud_row():
    spec = harness.load_spec()
    cfg = harness.load_config(spec, "poisson-cloud1m-f64")
    assert cfg["mesh"] == {"kind": "point_cloud", "n": 1048576,
                           "surface": "sphere", "seed": 3, "k": 12,
                           "order": "sampled"}
    assert cfg["neighbors"] == "stiffness" and cfg["hierarchy"] == {"nested": True}
    assert cfg["solver"]["dtype"] == "float64" and cfg["eta"] == 1e-6
    assert cfg["check"]["solve"] == {"residual": 1e-4, "residue_gap": 1e-7}
    assert cfg["control"]["dtype"] == "float32"


def test_the_tiny_cell_runs_correct_and_reads_its_counters(tiny):
    r = _run(tiny, CELL, trace=True)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert set(r["check"]) == {"residual", "residue_gap"}
    assert r["metrics"]["slots_per_nnz"]["value"] >= 1.0
    assert r["metrics"]["cycles_per_solve"]["value"] >= 1.0
    assert "loop_roofline" not in r["metrics"]      # no device clock here


def test_an_altered_answer_is_not_correct(tiny):
    r = _run(tiny, CELL, system=Broken("altered"))
    assert not r["correct"] and r["failed"] > 0, r["check"]


def _recorded(loop_device_ms, bytes_per_cycle=2_000_000_000, cycles=6.0,
              layout=True):
    timing = {"iterations": cycles}
    if loop_device_ms is not None:
        timing["loop_device"] = loop_device_ms
    calls = [Call(30.0, dict(timing), int(cycles), False) for _ in range(4)]
    calls.append(Call(30.0, {"iterations": cycles, "loop_device": 1e-6},
                      int(cycles), True))      # profiled: not read
    context = ({"layout_slots": 125.0, "layout_nnz": 100.0} if layout else {})
    return Run(kind="solve", setup_s=1.0, window_s=1.0, calls=calls,
               hierarchy_timing={}, context_timing=context,
               bytes_per_cycle=bytes_per_cycle, bytes_per_solve=1,
               hbm_bytes_per_s=roofline.hbm_bytes_per_s(roofline.DEFAULT_DEVICE))


def test_loop_roofline_on_a_recorded_run():
    read = harness.load_reader("loop_roofline")
    least_ms = 6 * 2e9 / 3.35e12 * 1000       # the bytes at the peak bandwidth
    assert read(_recorded(least_ms)) == pytest.approx(100.0)
    assert read(_recorded(2 * least_ms)) == pytest.approx(50.0)
    for ms in (least_ms * 1.01, 15.0, 19.0):
        assert 0 < read(_recorded(ms)) <= 100.0
    assert read(_recorded(None)) is None                 # no device clock
    assert read(_recorded(least_ms, bytes_per_cycle=0)) is None   # untraced


def test_slots_per_nnz_on_a_recorded_run():
    read = harness.load_reader("slots_per_nnz")
    assert read(_recorded(10.0)) == pytest.approx(1.25)
    assert read(_recorded(10.0, layout=False)) is None   # a program without them
