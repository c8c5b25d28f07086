"""Accumulating scope profiler and device traces.

Counterpart of ``gravo_mg_tpu/utils/profiler.py``.  The reference's SIG21
subsystem instruments hot scopes with ``PROFC_NODE(name)``, a static
per-site accumulator printing a ``name / count / total ms / mean us``
table at process exit (gravomg/src/sig21/profc.h:9-79).  The Python
equivalent::

    from gravo_mg_tpu_torch.utils.profiler import profile_scope, print_profile

    with profile_scope("cycle"):
        ...

    print_profile()          # or register_atexit() for exit-time printing

:func:`torch_trace` records a ``torch.profiler`` trace (host, and on a GPU
the device's kernels) of a block and writes it as a Chrome trace.

:class:`span` times one step of a call into that call's timing dict
(``solver_timing``), and names it on the profiler's host timeline while a
session records::

    with span(self.timing, "solve_deflation", host_only=True):
        ...
"""

from __future__ import annotations

import atexit
import contextlib
import os
import threading
import time
from typing import Dict, Optional


class _Node:
    __slots__ = ("name", "count", "elapsed_us")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.elapsed_us = 0.0


_nodes: Dict[str, _Node] = {}
_lock = threading.Lock()


@contextlib.contextmanager
def profile_scope(name: str):
    """Accumulate wall time of the enclosed block under ``name``.  Device
    work is asynchronous: synchronize inside the block to count it."""
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed_us = (time.perf_counter() - start) * 1e6
        with _lock:
            node = _nodes.get(name)
            if node is None:
                node = _nodes[name] = _Node(name)
            node.count += 1
            node.elapsed_us += elapsed_us


def profile_table() -> Dict[str, dict]:
    """Snapshot: name -> {count, total_ms, mean_us}."""
    with _lock:
        return {
            n.name: {
                "count": n.count,
                "total_ms": n.elapsed_us / 1e3,
                "mean_us": n.elapsed_us / max(n.count, 1),
            }
            for n in _nodes.values()
        }


def print_profile(file=None) -> None:
    """Print the profc-format table (name, count, total ms, mean us)."""
    import sys

    file = file or sys.stderr
    for name, row in profile_table().items():
        print(
            f"{name:<25} {row['count']:>10d} {row['total_ms']:>10.0f}ms "
            f"{row['mean_us']:>10.0f}us",
            file=file,
        )


def reset_profile() -> None:
    with _lock:
        _nodes.clear()


def _profiler_enabled() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


class span:
    """Store the block's host-clock milliseconds in ``timing[key]``
    (``timing=None`` stores nothing); ``t0`` is its start on that clock.

    With ``host_only=True`` and a ``torch.profiler`` session recording, the
    block is also ``record_function(key)`` on the host timeline.  Only a
    block that launches no device work (no kernel, copy or fill) may say
    ``host_only``: the profiler puts a range that encloses device work on
    the device timeline too, where it reads as one more device operation.
    With no session the span costs two ``perf_counter`` calls, one flag
    test and one dict store.
    """

    __slots__ = ("timing", "key", "host_only", "_range", "t0")

    def __init__(self, timing: Optional[dict], key: str, *, host_only: bool):
        self.timing, self.key, self.host_only = timing, key, host_only

    def __enter__(self):
        self._range = None
        if self.host_only and _profiler_enabled():
            from torch.profiler import record_function

            self._range = record_function(self.key)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self.t0) * 1000
        if self.timing is not None:
            self.timing[self.key] = ms
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


_registered = False


def register_atexit() -> None:
    """Print the table at interpreter exit, like profc's static dtor."""
    global _registered
    if not _registered:
        atexit.register(print_profile)
        _registered = True


@contextlib.contextmanager
def torch_trace(log_dir: str, name: Optional[str] = None):
    """Trace the block with ``torch.profiler`` and export a Chrome trace
    (``<log_dir>/<name or "trace">.json``).

    CPU activity is always recorded; CUDA activity too whenever a GPU is
    present.  The block runs inside ``record_function(name)``.  Yields the
    profiler, whose ``key_averages()`` and ``events()`` stay readable after
    the block.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    label = name or "trace"
    with profile(activities=activities) as prof:
        with record_function(label):
            yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"{label}.json"))
