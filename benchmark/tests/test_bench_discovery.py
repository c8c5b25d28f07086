"""A configuration, a cell, a traffic kind and a metric reader are files the
harness finds by name: adding one edits no file that is there."""

import hashlib
import json
import shutil

import pytest

from benchmark import harness
from benchmark.control import run_control
from benchmark.tests.tiny import tiny_root

READER = '''"""Calls in the window."""


def read(run):
    return float(len(run.calls))
'''


@pytest.fixture
def root(tmp_path):
    root, bench = tiny_root(tmp_path)
    for d in ("metrics", "kinds"):
        (bench / d).unlink()
        shutil.copytree(harness.BENCH_DIR / d, bench / d)
    return root, bench


def _files(root) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


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


def test_a_new_kind_is_found_by_name_for_the_program_and_the_control(root):
    """A copy of the solve kind under another name, a configuration whose
    check names it and a traffic of it: only new files and new entries.
    The program's side runs correct and feeds the unchanged ``solves_per_s``
    reader; the control's side, the kind's own bf16 stand-in, is not
    correct."""
    root, bench = root
    before = _files(root)
    before.pop("BENCHMARK.json")
    shutil.copy(bench / "kinds" / "solve.py", bench / "kinds" / "solve_again.py")
    traffic = json.loads((bench / "traffic" / "fused.json").read_text())
    traffic["kind"] = "solve_again"
    (bench / "traffic" / "again.json").write_text(json.dumps(traffic))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cfg = harness.load_config(spec, "poisson-torus1m-f32", root)
    cfg["name"] = "torus-again"
    cfg["check"] = {"solve_again": cfg["check"]["solve"]}
    assert cfg["control"]["dtype"] == "bfloat16"
    (bench / "configs" / "torus-again.json").write_text(json.dumps(cfg))
    spec["configs"].append({"name": "torus-again", "source": "test",
                            "file": "benchmark/configs/torus-again.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "again.fused", "config": "torus-again",
                              "traffic": "again", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if "poisson1m.fused" in m.get("workloads", []):
            m["workloads"].append("again.fused")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    r = harness.run_cell("again.fused", 2**31 + 41, 0.3, False, device="cpu",
                         root=root, bench_dir=bench)
    assert r["correct"] and r["failed"] == 0, r["check"]
    assert set(r["metrics"]) == {"solves_per_s", "setup_s"}
    assert r["metrics"]["solves_per_s"]["value"] > 0
    for line in run_control("again.fused", [2**31 + 43], 0.2, "cpu", root=root,
                            bench_dir=bench):
        assert line["correct"] is False, line
    after = _files(root)
    assert {k: after[k] for k in before} == before
    assert set(after) - set(before) == {
        "BENCHMARK.json", "benchmark/kinds/solve_again.py",
        "benchmark/traffic/again.json", "benchmark/configs/torus-again.json"}


def test_an_unknown_kind_names_the_directory_and_the_kinds_there(root):
    root, bench = root
    with pytest.raises(ValueError, match="kinds there: flow, solve") as e:
        harness.load_kind("minquad", bench)
    assert str(bench / "kinds") in str(e.value)
    traffic = json.loads((bench / "traffic" / "fused.json").read_text())
    traffic["kind"] = "minquad"
    (bench / "traffic" / "fused.json").write_text(json.dumps(traffic))
    with pytest.raises(ValueError, match="unknown traffic kind 'minquad'"):
        harness.run_cell("poisson1m.fused", 3, 0.3, False, device="cpu",
                         root=root, bench_dir=bench)


def test_every_metric_of_benchmark_json_has_its_reader():
    spec = harness.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for c in spec["workloads"]:
        kind = harness.load_kind(harness.load_traffic(c["traffic"])["kind"])
        assert kind.FAMILY in ("solve", "flow") and callable(kind.Cell)
        assert harness.load_config(spec, c["config"])["name"] == c["config"]
