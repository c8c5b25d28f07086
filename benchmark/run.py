"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Without as many CUDA devices as the cell asks for, it exits with code 2
and prints no result.  The last line of standard output is the result's
JSON object; the last lines of standard error are the numbers the check
compared, each beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# never loaded by a run: the JAX package and the libraries it brings
FORBIDDEN = {"jax", "jaxlib", "flax", "gravo_mg_tpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    with open(ROOT / "BENCHMARK.json") as f:
        cells = {c["name"]: c for c in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START)
    found = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
