"""One run of one cell, driven by data.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: its
configuration is the file that the ``configs`` entry of the same name
points at, its traffic is ``traffic/<traffic>.json`` beside this file, the
traffic's ``kind`` is ``kinds/<kind>.py``, and each metric it reports is
read by ``metrics/<name>.py``.  Adding any of these is adding a file;
nothing here names a cell, a configuration, a kind or a metric.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import pathlib
import sys
import time

import numpy as np

from . import loops, roofline
from .record import Run
from .trace import combine as trace_combine

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


_T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[bench {time.perf_counter() - _T0:8.3f}] {msg}", file=sys.stderr,
          flush=True)


# ---- discovery ---------------------------------------------------------------

def load_spec(root=ROOT) -> dict:
    with open(pathlib.Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(spec: dict, config: str, root=ROOT) -> dict:
    entry = find(spec["configs"], config, "configuration")
    with open(pathlib.Path(root) / entry["file"]) as f:
        return json.load(f)


def load_traffic(traffic: str, bench_dir=BENCH_DIR) -> dict:
    with open(pathlib.Path(bench_dir) / "traffic" / f"{traffic}.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones.  A metric without ``workloads``
    belongs to every cell that reports the metric it ``moves``."""
    def listed(m):
        return cell in m.get("workloads", [cell])

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def _load_file(path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(name: str, bench_dir=BENCH_DIR):
    path = pathlib.Path(bench_dir) / "metrics" / f"{name}.py"
    return _load_file(path, "benchmark.metrics." + name.replace(".", "_")).read


def load_kind(name: str, bench_dir=BENCH_DIR):
    """The traffic kind ``kinds/<name>.py``: its ``Cell`` (built as
    ``Cell(system, cfg, traffic, seed, log)``; ``span``, ``first_timing``,
    ``facade``, ``call(i, profiled) -> (Call, answer)``, ``referee()``, and
    optionally ``operators() -> loops.Operators``), and its ``FAMILY``, the
    family of metrics its calls feed (``Run.kind``)."""
    kinds = pathlib.Path(bench_dir) / "kinds"
    path = kinds / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        found = ", ".join(sorted(p.stem for p in kinds.glob("*.py"))) or "none"
        raise ValueError(f"unknown traffic kind {name!r}: no {name}.py in "
                         f"{kinds}; the kinds there: {found}")
    return _load_file(path, "benchmark.kinds." + name)


# ---- one run -----------------------------------------------------------------

def _profile(loop, count: int, span: str, applies) -> list:
    """``(call, Profile, whole)`` of ``count`` calls, each traced in a
    profiler session of its own (a session that recorded no device work at
    all is taken again, up to ``count`` more calls).  ``whole`` says that
    the trace holds at least as many kernels named *spmv* as the call made
    sparse applies (``applies`` per cycle dispatched, and the criterion's
    denominator): CUPTI records only the first pass of a conditional WHILE
    node's body, so a fused solve's trace is never whole."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .trace import reduce_events

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sessions = []
    for _ in range(2 * count):
        with profile(activities=activities) as prof:
            loop.run(count=1, profiled=True)
            if cuda:
                torch.cuda.synchronize()
        call = loop.calls[-1]
        p = reduce_events(prof.events(), {span})
        if p is None:
            continue
        need = None if applies is None else call.dispatched * applies + 1
        sessions.append((call, p, need is None or p.spmv_kernels >= need))
        log(f"profiled call: {p.spmv_kernels} spmv kernels, {need} applies")
        if len(sessions) == count:
            break
    return sessions


def _device(device: str, count: int) -> dict:
    import torch

    if device == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": count,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def _yardstick(run: Run, ops, cfg, device_kind) -> None:
    """The traced run's format-neutral bytes per cycle and per solve, from
    the operators the cell gives (none from a cell that gives none)."""
    if ops is None or any(a is None for a in (ops.lhs, ops.prolongations,
                                                 ops.mass)):
        return
    s = cfg["solver"]
    chain, U = roofline.galerkin_operators(ops.lhs, ops.prolongations)
    run.bytes_per_cycle, run.bytes_per_solve = roofline.cycle_bytes(
        chain, U, ops.mass, ops.columns, loops.ITEMSIZE[s["dtype"]],
        s["pre_iters"], s["post_iters"], s["cycle_type"])
    run.hbm_bytes_per_s = roofline.hbm_bytes_per_s(device_kind)


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", system=None, t_start: float | None = None,
             root=ROOT, bench_dir=BENCH_DIR) -> dict:
    """Set up the cell, drive it for ``seconds``, judge what it returned,
    and give the result line's object (``check`` last)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log(f"set-up: {time.perf_counter() - t_start:.3f} s since the process began")
    spec = load_spec(root)
    entry = find(spec["workloads"], cell_name, "cell")
    cfg = load_config(spec, entry["config"], root)
    traffic = load_traffic(entry["traffic"], bench_dir)
    system = loops.Program(device) if system is None else system
    kind = traffic["kind"]
    module = load_kind(kind, bench_dir)
    cell = module.Cell(system, cfg, traffic, seed, log)
    reservoir = loops.Reservoir(traffic["check_sample"],
                                  np.random.default_rng([seed, 1]))
    loop = loops.Loop(cell.call, reservoir, cell.span)
    sessions, ops = [], None
    if trace:
        s = cfg["solver"]
        ops = cell.operators() if hasattr(cell, "operators") else None
        U = None if ops is None else ops.prolongations
        applies = None if U is None else roofline.cycle_applies(
            len(U), s["pre_iters"], s["post_iters"])
        sessions = _profile(loop, int(traffic["profile_calls"]), cell.span,
                            applies)
        log(f"profiled {len(loop.calls)} calls, "
            f"{sum(w for *_, w in sessions)} traced whole")
    profile = trace_combine([p for _, p, whole in sessions if whole])
    seen = trace_combine([p for _, p, _ in sessions])
    t0, t1 = loop.run(seconds=seconds)
    setup_s = t0 - t_start
    walls = sorted(c.wall_ms for c in loop.calls if not c.profiled)
    log(f"window: {len(walls)} calls in {t1 - t0:.3f} s; ms min {walls[0]:.2f} "
        f"median {walls[len(walls) // 2]:.2f} max {walls[-1]:.2f}")
    dev = _device(device, entry["chips"])
    run = Run(kind=module.FAMILY, setup_s=setup_s, window_s=t1 - t0,
              calls=loop.calls,
              hierarchy_timing=dict(getattr(cell.facade, "hierarchy_timing", {})),
              context_timing=cell.first_timing or {}, profile=profile,
              traced=[c for c, _, whole in sessions if whole])
    if trace:
        _yardstick(run, ops, cfg, dev["kind"])
    referee = cell.referee()
    del cell, loop       # the program's state, before the reference runs
    gc.collect()
    judge = referee(reservoir.items, cfg["check"][kind])
    metrics = {}
    for m in cell_metrics(spec, cell_name, trace):
        value = load_reader(m["name"], bench_dir)(run)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": judge.correct, "attempted": len(run.calls),
              "failed": judge.failed, "metrics": metrics, "device": dev}
    if trace and seen is not None:
        # what the trace recorded: of a fused solve the first pass of the
        # loop's body only, so there busy_s is a lower bound
        dev["busy_s"] = seen.busy_s
        dev["window_s"] = seen.window_s
        result["breakdown"] = {"device_ops": seen.device_ops,
                               "idle_gaps": seen.idle_gaps}
    result["check"] = judge.numbers()
    return result
