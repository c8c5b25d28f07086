"""The control of ``correct``: a cell run with the reference in the
program's place, in the precision below the one its configuration states
(the configuration's ``control`` entry: bfloat16 for float32, float32 for
float64).  Its check has to come out not correct.  The benchmark's own runs
never run it.  Each traffic kind (``kinds/<kind>.py``) builds its own
stand-in for the program through :class:`Control`.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 3

prints one JSON line per seed: the seed, ``correct`` and the numbers the
check compared.
"""

import argparse
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


class Control:
    """The reference as the system under test, in ``dtype``: a kind builds
    it through ``build(program, control, *args)``, which calls the kind's
    ``control(side, *args)`` (``loops.Program`` calls ``program``)."""

    def __init__(self, device, dtype: str):
        self.device = device
        self.dtype = getattr(torch, dtype)
        self.np_dtype = {"float32": np.float32, "float64": np.float64}.get(dtype)

    def build(self, program, control, *args):
        return control(self, *args)


def run_control(cell: str, seeds, seconds: float, device: str, root=ROOT,
                bench_dir=None) -> list:
    from benchmark import harness

    bench_dir = harness.BENCH_DIR if bench_dir is None else bench_dir
    spec = harness.load_spec(root)
    entry = harness.find(spec["workloads"], cell, "cell")
    cfg = harness.load_config(spec, entry["config"], root)
    system = Control(device, cfg["control"]["dtype"])
    out = []
    for seed in seeds:
        r = harness.run_cell(cell, seed, seconds, False, device=device,
                             system=system, root=root, bench_dir=bench_dir)
        out.append({"seed": seed, "correct": r["correct"],
                    "attempted": r["attempted"], "check": r["check"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    seeds = [int(s) for s in args.seeds.split(",")]
    for line in run_control(args.workload, seeds, args.seconds, args.device):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
