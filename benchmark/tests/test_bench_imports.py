"""What a run loads: nothing of JAX or the JAX package, and the reference
nothing of the program; nothing the benchmark runs reads the JAX package's
benchmark scripts or their results."""

import json
import pathlib
import subprocess
import sys

from benchmark.harness import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "gravo_mg_tpu"}

RUN_TINY = """
import json, sys, tempfile
sys.path.insert(0, {root!r})
from benchmark.tests.tiny import tiny_root
from benchmark.harness import run_cell
root, bench = tiny_root(tempfile.mkdtemp(dir={tmp!r}))
for cell in ("poisson1m.fused", "smooth262k.flow", "smooth262k.rhs3"):
    for trace in (False, True):
        r = run_cell(cell, 5, 0.2, trace, device="cpu", root=root, bench_dir=bench)
        assert r["correct"], r
print(json.dumps(sorted(sys.modules)))
"""

IMPORT_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import benchmark.reference.check, benchmark.reference.mesh, benchmark.reference.solver
import benchmark.reference.inputs.torus, benchmark.reference.inputs.point_cloud
import benchmark.control
print(json.dumps(sorted(sys.modules)))
"""


def _modules(script) -> set:
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_nothing_of_jax(tmp_path):
    mods = _modules(RUN_TINY.format(root=str(ROOT), tmp=str(tmp_path)))
    assert "gravo_mg_tpu_torch" in mods
    assert not {m.split(".")[0] for m in mods} & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(IMPORT_REFERENCE.format(root=str(ROOT)))
    tops = {m.split(".")[0] for m in mods}
    assert not tops & (FORBIDDEN | {"gravo_mg_tpu_torch"})


def test_no_benchmark_source_reads_the_jax_packages_scripts():
    for path in BENCH_DIR.rglob("*.py"):
        if "tests" in path.relative_to(BENCH_DIR).parts:
            continue
        text = path.read_text()
        for name in ("chip_smoke", "bench.py", "BENCH_r", "BASELINE", "MULTICHIP"):
            assert name not in text, (path, name)
