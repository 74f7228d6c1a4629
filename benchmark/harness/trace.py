"""A traced window: torch.profiler's device activity, reduced to busy
time, device time by harness range, device time of the program's own
kernels, and the breakdown that the result line carries.

The harness opens ``record_function`` ranges named ``bench:<layer>``
around its calls into the program, and one ``bench:window`` around the
traced items (which ends after a synchronise). A device operation
belongs to the innermost harness range that launched it: the profiler's
device-side copy of a range spans the operations launched inside it, and
one stream runs them in launch order. (The profiler makes those copies
only with CPU activity traced.) Times are the profiler's, in
nanoseconds, read from its events in memory: no trace file is written.

Recording CPU activity costs the host time on every operation, which
lengthens a host-bound item and so the device's idle gaps. The device's
busy time and span are therefore taken from a capture of its own that
records device activity alone (``device_window``), over the same items
run once more.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import re
import time

PREFIX = "bench:"
WINDOW = PREFIX + "window"


def busy_and_span(intervals) -> tuple[float, float]:
    """Union length and extent of ``(start, end)`` intervals."""
    intervals = sorted(intervals)
    busy, (lo, hi) = 0.0, intervals[0]
    first = lo
    last = max(end for _, end in intervals)
    for start, end in intervals[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return busy + hi - lo, last - first


def merged(intervals) -> list[tuple[float, float]]:
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], end))
        else:
            out.append((start, end))
    return out


@contextlib.contextmanager
def span(name: str):
    """A harness range ``bench:<name>``."""
    from torch.profiler import record_function
    with record_function(PREFIX + name):
        yield


def device_window(out: dict):
    """A traced window (for a runner's ``trace``) profiled for device
    activity alone; fills ``out`` with ``busy_s`` and ``span_s`` (the
    union and the extent of the device operations) and ``window_s``, the
    window's length on the host clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    @contextlib.contextmanager
    def window():
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        ivs = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda and not e.is_user_annotation()]
        if not ivs:
            raise RuntimeError("trace: no device activity in the "
                               "device-only window")
        busy, extent = busy_and_span(ivs)
        out.update(busy_s=busy * 1e-9, span_s=extent * 1e-9,
                   window_s=t1 - t0, device_ops=len(ivs))
    return window


def label(name: str, kernels=()) -> str:
    """A device operation's short name: the program kernel's name in it,
    else its first 60 characters."""
    for k in kernels:
        if re.search(rf"(?<![A-Za-z_]){k}(?![A-Za-z0-9_])", name):
            return k
    return name[:60]


class Trace:
    """The device and host activity of one profiled block."""

    def __init__(self, events):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        self.device, self.dev_ranges, self.host_ranges = [], [], []
        for e in events:
            name, start = e.name(), e.start_ns()
            end = start + e.duration_ns()
            if e.device_type() == cuda:
                if e.is_user_annotation():
                    if name.startswith(PREFIX):
                        self.dev_ranges.append((start, end, name))
                else:
                    self.device.append((start, end, name))
            elif e.is_user_annotation() and name.startswith(PREFIX):
                self.host_ranges.append((start, end, name))
        windows = [r for r in self.host_ranges if r[2] == WINDOW]
        if len(windows) != 1:
            raise RuntimeError(f"trace: {len(windows)} {WINDOW} ranges")
        self.window = windows[0][:2]
        self.host_ranges.sort()
        self._owner = self._owners()

    @classmethod
    @contextlib.contextmanager
    def capture(cls):
        """Profile the block; yields a list that holds the ``Trace`` after."""
        from torch.profiler import ProfilerActivity, profile
        out = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            yield out
        out.append(cls(prof.profiler.kineto_results.events()))

    # -- attribution ---------------------------------------------------

    def _innermost(self, ranges, t0, t1=None):
        """The shortest range of ``ranges`` holding [t0, t1]."""
        t1 = t0 if t1 is None else t1
        best = None
        for start, end, name in ranges:
            if start <= t0 and t1 <= end and (
                    best is None or end - start < best[1] - best[0]):
                best = (start, end, name)
        return best[2] if best else None

    def _owners(self) -> list:
        """The innermost device-side range around each device operation."""
        inner = sorted(r for r in self.dev_ranges if r[2] != WINDOW)
        starts = [r[0] for r in inner]
        out = []
        for start, end, _ in self.device:
            i = bisect.bisect_right(starts, start)
            cands = [r for r in inner[max(0, i - 8):i]
                     if r[0] <= start and end <= r[1]]
            out.append(min(cands, key=lambda r: r[1] - r[0])[2]
                       if cands else None)
        return out

    def in_window(self):
        lo, hi = self.window
        return [(max(s, lo), min(e, hi), n) for s, e, n in self.device
                if e > lo and s < hi]

    # -- readings --------------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def busy_and_span_s(self) -> tuple[float, float]:
        ivs = [(s, e) for s, e, _ in self.in_window()]
        if not ivs:
            raise RuntimeError("trace: no device activity in the window")
        busy, extent = busy_and_span(ivs)
        return busy * 1e-9, extent * 1e-9

    def range_ms(self, name: str) -> float | None:
        """Device ms of the operations launched inside ``bench:<name>``
        ranges in the window; None where none was seen."""
        lo, hi = self.window
        want = PREFIX + name
        total, seen = 0.0, False
        for (s, e, _), owner in zip(self.device, self._owner):
            if owner == want and lo <= s < hi:
                total += e - s
                seen = True
        return total * 1e-6 if seen else None

    def _named(self, kernels):
        pat = re.compile(r"(?<![A-Za-z_])(" + "|".join(sorted(kernels))
                         + r")(?![A-Za-z0-9_])")
        return [(s, e) for s, e, n in self.in_window() if pat.search(n)]

    def kernels_ms(self, kernels) -> float | None:
        """Device ms of the operations named by ``kernels`` in the window."""
        named = self._named(kernels)
        return sum(e - s for s, e in named) * 1e-6 if named else None

    def kernel_count(self, kernels) -> int:
        """How many operations named by ``kernels`` ran in the window."""
        return len(self._named(kernels))

    def breakdown(self, kernels=()) -> dict:
        """The 10 device operations that took most time (by name) and the
        10 longest idle gaps, each labelled by the harness range the host
        was in at the gap's middle."""
        ops = collections.Counter()
        for s, e, n in self.in_window():
            ops[label(n, kernels)] += (e - s) * 1e-9
        busy = merged((s, e) for s, e, _ in self.in_window())
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])]
        gaps.sort(reverse=True)
        host = [r for r in self.host_ranges if r[2] != WINDOW]
        idle = []
        for length, g0, g1 in gaps[:10]:
            owner = self._innermost(host, (g0 + g1) / 2)
            idle.append([owner[len(PREFIX):] if owner else "outside ranges",
                         length * 1e-9])
        return {"device_ops": [[k, v] for k, v in ops.most_common(10)],
                "idle_gaps": idle}
