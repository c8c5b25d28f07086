"""A copy of the benchmark's cells at a size the CPU runs in seconds."""

import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def tiny_root(tmp_path, nu=32, nv=16, lower_bound=64):
    """A checkout-like root under ``tmp_path``: BENCHMARK.json's cells with
    each configuration's torus cut to ``nu`` x ``nv``, small pools and
    samples, and the real metric readers."""
    root = pathlib.Path(tmp_path)
    bench = root / "benchmark"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    (bench / "metrics").symlink_to(BENCH / "metrics")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["mesh"].update(nu=nu, nv=nv)
        cfg["solver"]["lower_bound"] = lower_bound
        c["file"] = f"benchmark/configs/{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    for path in (BENCH / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(pool=3, warmup_calls=1, warmup_steps=1, profile_calls=2,
                 check_sample=4)
        (bench / "traffic" / path.name).write_text(json.dumps(t))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root, bench
