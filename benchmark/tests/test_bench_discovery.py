"""A configuration, a cell and a metric reader are files the harness finds
by name: adding one edits no file that is there."""

import json
import shutil

import pytest

from benchmark import harness
from benchmark.tests.tiny import tiny_root

READER = '''"""Calls in the window."""


def read(run):
    return float(len(run.calls))
'''


@pytest.fixture
def root(tmp_path):
    root, bench = tiny_root(tmp_path)
    (bench / "metrics").unlink()
    shutil.copytree(harness.BENCH_DIR / "metrics", bench / "metrics")
    return root, bench


def test_a_new_config_cell_and_metric_are_found_by_name(root):
    root, bench = root
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = json.loads((root / spec["configs"][1]["file"]).read_text())
    cfg["name"] = "smooth-torus-tiny"
    (bench / "configs" / "smooth-torus-tiny.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "rhs3.json").read_text())
    traffic.update(columns=2, mode="fused")
    (bench / "traffic" / "rhs2fused.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "calls_seen.py").write_text(READER)
    spec["configs"].append({"name": "smooth-torus-tiny", "source": "test",
                            "file": "benchmark/configs/smooth-torus-tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny.rhs2fused", "config": "smooth-torus-tiny",
                              "traffic": "rhs2fused", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "smooth262k.rhs3" in m["workloads"]:
            m["workloads"].append("tiny.rhs2fused")
    spec["per_layer"].append({"name": "calls_seen", "unit": "calls", "better": "higher",
                              "source": "host_clock", "layer": "facade",
                              "moves": "solves_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    names = [m["name"] for m in harness.cell_metrics(spec, "tiny.rhs2fused", True)]
    assert "calls_seen" in names and "update_lhs_ms" not in names
    assert harness.load_config(spec, "smooth-torus-tiny", root)["name"] == "smooth-torus-tiny"
    assert harness.load_traffic("rhs2fused", bench)["columns"] == 2
    r = harness.run_cell("tiny.rhs2fused", 3, 0.3, True, device="cpu",
                         root=root, bench_dir=bench)
    assert r["correct"]
    assert r["metrics"]["calls_seen"]["value"] == r["attempted"]
    r = harness.run_cell("tiny.rhs2fused", 3, 0.3, False, device="cpu",
                         root=root, bench_dir=bench)
    assert set(r["metrics"]) == {"solves_per_s", "solve_ms_p95", "setup_s"}
    assert list(r)[-1] == "check"


def test_every_metric_of_benchmark_json_has_its_reader():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for c in spec["workloads"]:
        assert harness.load_traffic(c["traffic"])["kind"] in ("solve", "flow")
        assert harness.load_config(spec, c["config"])["name"] == c["config"]
