"""A copy of the benchmark's cells at a size the CPU runs in seconds."""

import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def cut(cfg, nu=32, nv=16, n=2000):
    """Cut a configuration's mesh in place: a torus to ``nu`` x ``nv``,
    a point cloud to ``n`` points."""
    if cfg["mesh"]["kind"] == "torus":
        cfg["mesh"].update(nu=nu, nv=nv)
    else:
        cfg["mesh"]["n"] = n


def tiny_root(tmp_path, nu=32, nv=16, lower_bound=64, n=2000):
    """A checkout-like root under ``tmp_path``: BENCHMARK.json's cells with
    each configuration's torus cut to ``nu`` x ``nv`` and each point cloud
    to ``n`` points, small pools and samples, and the real traffic kinds
    and metric readers."""
    root = pathlib.Path(tmp_path)
    bench = root / "benchmark"
    (bench / "configs").mkdir(parents=True)
    (bench / "traffic").mkdir()
    (bench / "metrics").symlink_to(BENCH / "metrics")
    (bench / "kinds").symlink_to(BENCH / "kinds")
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cut(cfg, nu=nu, nv=nv, n=n)
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
