"""The run command fails, and prints no result, without a card."""

import os
import subprocess
import sys

from benchmark.harness import ROOT


def test_run_exits_non_zero_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "poisson1m.fused",
         "--seed", str(2**31 + 11), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA device" in out.stderr
