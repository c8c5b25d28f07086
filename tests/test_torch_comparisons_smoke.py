"""End-to-end smoke of the port's comparison harness
(``gravo_mg_tpu_torch.experiments.comparisons``), the counterpart of
``tests/test_comparisons_smoke.py``.

One tiny generated shape (``icosphere(3, bump=0.1)``, 642 vertices,
``--lower_bound 100`` so that every hierarchy has levels) goes through
every section (direct, SIG21, SIG06, CG, ours, and a second run with
``--ablation``) and the port's table generator, on the CPU, in a
subprocess that must not import JAX.  Its CSVs are read by the JAX
package's table generator as well, and its cycle counts (ours, SIG06,
SIG21) equal the JAX harness's on the same shape and flags.
"""

import csv
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
FLAGS = ["--sig06", "--direct", "--cg", "--tolerance", "1e-4", "--lower_bound", "100"]
SHAPE = """
from {pkg}.utils.meshgen import icosphere
V, F = icosphere(3, bump=0.1)
comparisons.generated_shapes = lambda sizes: [("sphere_s", V, F)]
"""


def _run(code, tmp):
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert "SMOKE-OK" in out.stdout, (out.stdout[-2000:], out.stderr[-3000:])


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("port") / "timing"
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from gravo_mg_tpu_torch.experiments import comparisons
{SHAPE.format(pkg="gravo_mg_tpu_torch")}
for label, extra in (("smoke", []), ("ablation", ["--ablation", "--nosig21"])):
    table = comparisons.main(["--label", label, "--out_dir", {str(tmp)!r},
                              "--device", "cpu", "--num_repetitions", "2",
                              *{FLAGS!r}, *extra])
    assert len(table) == 1, table
assert "jax" not in sys.modules, "the port's harness imported JAX"
print("SMOKE-OK")
"""
    _run(code, tmp)
    return tmp


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.DictReader(fh))


def test_port_comparisons_harness_smoke(port_run):
    table = _rows(port_run / "smoke_0.001_table.csv")
    assert len(table) == 1
    row = table[0]
    for key in ("mean_residue", "sig06_residue", "sig21_residue"):
        assert float(row[key]) <= 1e-4, (key, row[key])
    assert float(row["cg_solver"]) > 0 and float(row["direct_factor"]) >= 0
    assert (port_run.parent / "latex" / "comparisons_smoke_0.001.tex").exists()
    ablation = _rows(port_run / "ablation_0.001_table.csv")[0]
    assert float(ablation["mean_residue"]) <= 1e-4
    # cold and warm solve of every repetition
    ours = _rows(port_run / "solver_ours_tau0.001_smoke.csv")
    assert len(ours) == 2 and all(float(r["warm_cycles"]) > 0 for r in ours)
    # the JAX package's table generator reads the port's CSVs
    sys.path.insert(0, str(REPO / "experiments"))
    try:
        from comparisons_to_table import save_to_table
    finally:
        sys.path.remove(str(REPO / "experiments"))
    jt = save_to_table(str(port_run), 0.001, "smoke", sig21=True, sig06=True,
                       direct=True, cg=True)
    for key in ("mean_iterations", "sig06_iterations", "sig21_iterations"):
        assert float(jt[key].iloc[0]) == float(row[key]), key


def test_port_harness_cycles_match_jax(port_run, tmp_path):
    code = f"""
import sys
sys.path.insert(0, {str(REPO / 'experiments')!r})
sys.path.insert(0, {str(REPO)!r})
import jax; jax.config.update("jax_platforms", "cpu")
import comparisons
args = comparisons.build_parser().parse_args(
    ["--label", "smoke", "--out_dir", {str(tmp_path)!r}, "--num_repetitions", "2",
     *{FLAGS!r}])
from gravo_mg_tpu import Sampling, Weighting
args.sampling = Sampling.FASTDISK
args.weighting = Weighting.BARYCENTRIC
args.sig21 = True
{SHAPE.format(pkg="gravo_mg_tpu")}
comparisons.run(args)
print("SMOKE-OK")
"""
    _run(code, tmp_path)
    for name in ("solver_ours", "solver_sig06", "solver_sig21"):
        f = f"{name}_tau0.001_smoke.csv"
        want = [float(r["iterations"]) for r in _rows(tmp_path / f)]
        got = [float(r["iterations"]) for r in _rows(port_run / f)]
        assert got == want and min(got) > 1, (name, got, want)
