"""Reduction of a ``torch.profiler`` session to the traced run's numbers.

The profiled window runs from the start of the first of the benchmark's own
spans (``facade.solve``, ``flow.step``) to the end of the last.  Device
operations are the profiler's CUDA events, less the spans' own annotations
on the device timeline; the device is busy where any of them runs, and idle
in the gaps between, which are labelled by the innermost host event of the
spans' thread that was open during them.
"""

from __future__ import annotations

import dataclasses
import re
from collections import defaultdict


@dataclasses.dataclass
class Profile:
    window_s: float
    busy_s: float
    kernels: int               # device kernels (copies and fills not counted)
    spmv_kernels: int          # of them, the kernels named *spmv*
    spmv_s: float              # and their device time
    device_ops: list           # [[name, seconds], ...], most time first
    idle_gaps: list            # [[host label, seconds], ...], most time first

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s


def combine(profiles, top: int = 10):
    """One ``Profile`` of several sessions: times and counts added, the
    lists merged by name."""
    profiles = [p for p in profiles if p is not None]
    if not profiles:
        return None

    def merged(key):
        acc = defaultdict(float)
        for p in profiles:
            for name, sec in getattr(p, key):
                acc[name] += sec
        return [[n, s] for n, s in sorted(acc.items(), key=lambda kv: -kv[1])[:top]]

    return Profile(
        window_s=sum(p.window_s for p in profiles),
        busy_s=sum(p.busy_s for p in profiles),
        kernels=sum(p.kernels for p in profiles),
        spmv_kernels=sum(p.spmv_kernels for p in profiles),
        spmv_s=sum(p.spmv_s for p in profiles),
        device_ops=merged("device_ops"), idle_gaps=merged("idle_gaps"))


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", "") == "CUDA"


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def short_name(name: str) -> str:
    """A kernel's name without its parameter list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0 and out:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:160]


def merge(intervals) -> list:
    """Union of ``(start, end)`` intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def innermost(intervals) -> list:
    """``(start, end, name)`` of nested host events, flattened to disjoint
    segments each labelled by the innermost event open over it."""
    segs, stack, cur = [], [], None
    for s, e, name in sorted(intervals, key=lambda t: (t[0], -t[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            if top[1] > cur:
                segs.append((cur, top[1], top[2]))
                cur = top[1]
        if stack and s > cur:
            segs.append((cur, s, stack[-1][2]))
        cur = s if cur is None else max(cur, s)
        stack.append((s, e, name))
    while stack:
        top = stack.pop()
        if top[1] > cur:
            segs.append((cur, top[1], top[2]))
            cur = top[1]
    return segs


def label_gaps(gaps, segments) -> dict:
    """Seconds of each gap's time under each host label (µs in)."""
    out = defaultdict(float)
    j = 0
    for g0, g1 in gaps:
        while j < len(segments) and segments[j][1] <= g0:
            j += 1
        covered, k = 0.0, j
        while k < len(segments) and segments[k][0] < g1:
            s0, s1, name = segments[k]
            overlap = min(g1, s1) - max(g0, s0)
            if overlap > 0:
                out[name] += overlap / 1e6
                covered += overlap
            k += 1
        if g1 - g0 > covered:
            out["(no host event)"] += (g1 - g0 - covered) / 1e6
    return out


def reduce_events(events, span_names, top=None) -> Profile | None:
    """The ``Profile`` of a session's events, or None where the spans or
    the device recorded nothing."""
    spans = [e for e in events if not _is_device(e) and e.name in span_names]
    device = [e for e in events if _is_device(e) and e.name not in span_names]
    if not spans or not device:
        return None
    w0 = min(e.time_range.start for e in spans)
    w1 = max(e.time_range.end for e in spans)
    thread = spans[0].thread
    by_name = defaultdict(float)
    intervals, kernels, spmv_kernels, spmv_us = [], 0, 0, 0.0
    for e in device:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        intervals.append((s, t))
        name = short_name(e.name)
        by_name[name] += (t - s) / 1e6
        if _is_kernel(e.name):
            kernels += 1
            if "spmv" in e.name:
                spmv_kernels += 1
                spmv_us += t - s
    busy = merge(intervals)
    busy_us = sum(t - s for s, t in busy)
    gaps, cur = [], w0
    for s, t in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, t)
    if w1 > cur:
        gaps.append((cur, w1))
    host = [(e.time_range.start, e.time_range.end, e.name) for e in events
            if not _is_device(e) and e.thread == thread
            and e.time_range.end > w0 and e.time_range.start < w1]
    labelled = label_gaps(gaps, innermost(host))
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(labelled.items(), key=lambda kv: -kv[1])[:top]
    return Profile(
        window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6, kernels=kernels,
        spmv_kernels=spmv_kernels, spmv_s=spmv_us / 1e6, device_ops=[[n, s] for n, s in ops],
        idle_gaps=[[n, s] for n, s in idle])
