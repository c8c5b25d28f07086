"""The port's scope profiler (profc.h analog) and ``torch_trace``."""

import io
import json
import os
import time

import torch

from gravo_mg_tpu_torch.utils.profiler import (
    print_profile,
    profile_scope,
    profile_table,
    reset_profile,
    torch_trace,
)


def test_profile_accumulates():
    reset_profile()
    for _ in range(3):
        with profile_scope("work"):
            time.sleep(0.001)
    table = profile_table()
    assert table["work"]["count"] == 3
    assert table["work"]["total_ms"] >= 3 * 0.9  # >= ~3ms
    assert table["work"]["mean_us"] >= 900

    buf = io.StringIO()
    print_profile(buf)
    out = buf.getvalue()
    assert "work" in out and "ms" in out
    reset_profile()
    assert profile_table() == {}


def test_torch_trace_writes_chrome_trace(tmp_path):
    """On the CPU: a trace file with the named range and the matmul."""
    a = torch.randn(64, 64)
    with torch_trace(str(tmp_path), name="block") as prof:
        (a @ a).sum()
    path = os.path.join(str(tmp_path), "block.json")
    with open(path) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "block" in names
    assert any("mm" in (n or "") for n in names)
    assert any(e.key == "block" for e in prof.key_averages())
