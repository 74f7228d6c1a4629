"""The measured window's arithmetic.

A rate is all the work completed in the window over the whole window; a
tail is the percentile of every item of the window. Nothing is a median
of rounds or chunks. The window starts with the first timed item and ends
when the last item completes; items start while the clock is under the
window's length.
"""

from __future__ import annotations

import gc
import math
import resource
import time
from pathlib import Path


def percentile(values, q: float) -> float:
    """Nearest-rank ``q``-th percentile (0 < q <= 100) of all ``values``."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


class Window:
    """Items timed on the host clock: ``item()`` marks one item's start,
    ``done(n)`` its completion with ``n`` units of work."""

    def __init__(self, seconds: float, clock=time.perf_counter):
        self.seconds = seconds
        self.clock = clock
        self.start = None
        self.end = None
        self.latencies: list[float] = []
        self.units = 0
        self.marks: list[tuple[float, int]] = []      # (time, units so far)
        self._t = None

    def open(self) -> None:
        self.start = self.clock()

    def more(self) -> bool:
        """Whether another item starts."""
        return self.clock() - self.start < self.seconds

    def item(self) -> None:
        self._t = self.clock()

    def done(self, units: int = 1) -> None:
        now = self.clock()
        self.latencies.append(now - self._t)
        self.add(units, now)

    def add(self, units: int, now: float | None = None) -> None:
        """``units`` of work completed now (an item not timed alone)."""
        now = self.clock() if now is None else now
        self.units += units
        self.end = now
        self.marks.append((now, self.units))

    def close(self) -> None:
        """End the window now (after a final synchronise)."""
        self.end = self.clock()

    @property
    def length(self) -> float:
        return self.end - self.start

    def rate(self) -> float:
        return self.units / self.length

    def p95_ms(self) -> float:
        return 1e3 * percentile(self.latencies, 95)

    def halves(self) -> tuple[float, float]:
        """The rate in the first and the second half of the window (a
        diagnostic: something that warms up inside the window shows)."""
        mid = self.start + self.length / 2
        first = max((u for t, u in self.marks if t <= mid), default=0)
        return (first / (mid - self.start),
                (self.units - first) / (self.end - mid))


def _cgroup_cpu() -> dict:
    """The cgroup's CPU throttling counters, where the system has them."""
    try:
        text = Path("/sys/fs/cgroup/cpu.stat").read_text()
    except OSError:
        return {}
    return {k: int(v) for k, v in (line.split() for line in text.splitlines())
            if k in ("usage_usec", "nr_throttled", "throttled_usec")}


class HostReadings:
    """What the host did while the block ran (a diagnostic for runs that
    spread): the calling thread's CPU seconds and context switches, the
    process's CPU seconds, the garbage collector's collections and
    seconds by generation, and the cgroup's CPU throttling."""

    def __enter__(self):
        self.gc = {}
        self._gc_t = None
        gc.callbacks.append(self._on_gc)
        self._start = self._now()
        return self

    def _on_gc(self, phase, info):
        if phase == "start":
            self._gc_t = time.perf_counter()
        elif self._gc_t is not None:
            n, sec = self.gc.get(info["generation"], (0, 0.0))
            self.gc[info["generation"]] = (
                n + 1, sec + time.perf_counter() - self._gc_t)

    @staticmethod
    def _now() -> dict:
        ru = resource.getrusage(getattr(resource, "RUSAGE_THREAD",
                                        resource.RUSAGE_SELF))
        return {"thread_cpu_s": time.thread_time(),
                "process_cpu_s": time.process_time(),
                "voluntary_switches": ru.ru_nvcsw,
                "involuntary_switches": ru.ru_nivcsw,
                **{f"cgroup_{k}": v for k, v in _cgroup_cpu().items()}}

    def __exit__(self, *exc):
        gc.callbacks.remove(self._on_gc)
        end = self._now()
        self.readings = {k: end[k] - v for k, v in self._start.items()
                         if k in end}
        self.readings["gc"] = {str(g): list(v)
                               for g, v in sorted(self.gc.items())}
        return False
