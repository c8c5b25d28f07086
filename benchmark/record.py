"""What one run recorded, which the metric readers take their numbers from,
and the statistics they use."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Optional

from .trace import Profile


@dataclasses.dataclass
class Call:
    """One call of the cell's entry in the window."""

    wall_ms: float            # host clock, from the call to its return
    timing: dict              # the solver's ``solver_timing`` after it
    dispatched: int           # cycles the device ran for it
    profiled: bool            # inside the profiled part of a traced run


@dataclasses.dataclass
class Run:
    """A run's record: the window's calls and the set-up's spans."""

    kind: str                          # the kind's FAMILY: "solve" or "flow"
    setup_s: float                     # process start to window start
    window_s: float                    # window start to the last call's end
    calls: list                        # [Call]
    hierarchy_timing: dict             # the solver's ``hierarchy_timing``
    context_timing: dict               # ``solver_timing`` after the first solve
    profile: Optional[Profile] = None  # the traced run's profiler sessions
    traced: list = dataclasses.field(default_factory=list)  # [Call] in them
    bytes_per_cycle: int = 0           # format-neutral bytes of a cycle's applies
    bytes_per_solve: int = 0           # and of a solve's own
    hbm_bytes_per_s: float = 0.0       # the card's peak memory bandwidth

    @property
    def plain(self) -> list:
        """The calls outside the profiled part (host spans read these)."""
        return [c for c in self.calls if not c.profiled]


def rate(count: int, seconds: float) -> Optional[float]:
    return count / seconds if count and seconds > 0 else None


def p95(values) -> Optional[float]:
    """95th percentile, ``statistics.quantiles`` (inclusive) over all values."""
    values = list(values)
    if len(values) < 2:
        return values[0] if values else None
    return statistics.quantiles(values, n=100, method="inclusive")[94]


def mean(values) -> Optional[float]:
    values = list(values)
    return sum(values) / len(values) if values else None


def timing_mean(calls, *keys) -> Optional[float]:
    """Mean over the calls whose timing has every key of the keys' sum."""
    return mean(sum(c.timing[k] for k in keys) for c in calls
                if all(k in c.timing for k in keys))
