"""The program's own spans and counters in a traced window: host ms in a
part of the program an item, and the device's idle time by the part of the
program the host was in.

``istnet_tpu_torch/utils/tracing.py`` keeps a record of each span the
program opens under the profiler (``serve``, ``h2d``, ``forward``,
``step.update`` ...; the list is in ``PERF.md``, section 3), with its
parent and its start and end on the Unix clock in nanoseconds, the clock
of the profiler's events. ``Spans.of(r)`` takes those that lie inside the
traced window (the ``bench:window`` range of ``r["trace"]``). Each
nanosecond of device idle time (the gaps between the device's busy
intervals in the window, merged as ``Trace.breakdown`` merges them) goes
to the innermost span the host was in at that moment, or to none
(``OUTSIDE``).

A program without the tracing module, or a run in which a span was never
opened, gives None: the reader then has nothing to read.

``METRICS`` are the manifest entries of the readers under
``benchmark/metrics/`` that read these spans and counters.
"""

from __future__ import annotations

import collections

from benchmark.harness.trace import merged

OUTSIDE = None


def program():
    """The program's tracing module, or None where it has none."""
    try:
        from istnet_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def counters() -> dict | None:
    """The program's counters (over the process), or None."""
    tracing = program()
    return None if tracing is None else tracing.counters()


class Spans:
    """The program's span records that lie inside ``window`` (start, end
    in ns); ``records`` are ``(name, start_ns, end_ns, parent, item)``
    with ``parent`` an index into them (-1: none)."""

    def __init__(self, records, window):
        self.records = list(records)
        self.window = lo, hi = window
        self.inside = [i for i, r in enumerate(self.records)
                       if lo <= r[1] and r[2] <= hi]

    @classmethod
    def of(cls, r: dict) -> "Spans | None":
        tracing = program()
        if tracing is None:
            return None
        return cls(tracing.records(), r["trace"].window)

    def chain(self, i: int):
        """The names of span ``i`` and of the spans around it, innermost
        first."""
        while i >= 0:
            yield self.records[i][0]
            i = self.records[i][3]

    def _named(self, name: str, under: str | None):
        return [i for i in self.inside if self.records[i][0] == name
                and (under is None or under in list(self.chain(i))[1:])]

    def host_ms(self, name: str, under: str | None = None) -> float | None:
        """Host ms in the spans ``name`` (inside a span ``under``), their
        children included; None where there is none."""
        spans = self._named(name, under)
        if not spans:
            return None
        return sum(self.records[i][2] - self.records[i][1]
                   for i in spans) * 1e-6

    def self_ms(self) -> dict:
        """{name: host ms in the spans of that name, less the spans
        directly inside them}."""
        out, inside = collections.Counter(), set(self.inside)
        for i in self.inside:
            name, start, end, parent, _ = self.records[i]
            out[name] += (end - start) * 1e-6
            if parent in inside:
                out[self.records[parent][0]] -= (end - start) * 1e-6
        return dict(out)

    def timeline(self) -> list:
        """``(t0, t1, span index or OUTSIDE)`` segments over the window,
        each under the innermost span open on the host over it."""
        lo, hi = self.window
        rec = self.records
        segments, stack, t = [], [], lo

        def close(limit):
            nonlocal t
            while stack and rec[stack[-1]][2] <= limit:
                i = stack.pop()
                if rec[i][2] > t:
                    segments.append((t, rec[i][2], i))
                    t = rec[i][2]

        for i in sorted(self.inside, key=lambda i: (rec[i][1], -rec[i][2])):
            close(rec[i][1])
            if rec[i][1] > t:
                segments.append((t, rec[i][1], stack[-1] if stack
                                 else OUTSIDE))
                t = rec[i][1]
            stack.append(i)
        close(hi)
        if hi > t:
            segments.append((t, hi, OUTSIDE))
        return segments

    def idle_ns(self, busy) -> collections.Counter:
        """{span index or OUTSIDE: ns of device idle time}: the gaps
        between the merged ``busy`` intervals, clipped to the window, each
        nanosecond under the span the host was in."""
        lo, hi = self.window
        busy = merged(busy)
        gaps = [(max(a[1], lo), min(b[0], hi))
                for a, b in zip(busy, busy[1:])]
        out = collections.Counter()
        segments, j = self.timeline(), 0
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            while j < len(segments) and segments[j][1] <= g0:
                j += 1
            k = j
            while k < len(segments) and segments[k][0] < g1:
                t0, t1, owner = segments[k]
                out[owner] += min(t1, g1) - max(t0, g0)
                k += 1
        return out

    def idle_share(self, busy, names) -> float | None:
        """% of the device's idle time in which the host was inside a span
        named in ``names`` or a span under one; None where no such span
        was opened in the window."""
        if not any(self.records[i][0] in names for i in self.inside):
            return None
        idle = self.idle_ns(busy)
        total = sum(idle.values())
        if not total:
            return 0.0
        part = sum(ns for owner, ns in idle.items() if owner is not OUTSIDE
                   and any(n in names for n in self.chain(owner)))
        return 100.0 * part / total


def device_busy(r: dict) -> list:
    """The device's busy intervals in the traced window."""
    return [(s, e) for s, e, _ in r["trace"].in_window()]


def host_ms_per_item(r: dict, name: str, under: str | None = None):
    """Host ms a traced item in the spans ``name`` (inside ``under``)."""
    spans = Spans.of(r)
    ms = None if spans is None else spans.host_ms(name, under)
    return None if ms is None else ms / r["traced"]["items"]


def idle_share(r: dict, names) -> float | None:
    """``Spans.idle_share`` of the traced window's device activity."""
    spans = Spans.of(r)
    return None if spans is None else spans.idle_share(device_busy(r), names)


def _entry(name, unit, source, layer, moves, cell):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves,
            "workloads": [f"istnet_r18_n1024.{cell}"]}


METRICS = [
    _entry("h2d.host_ms_per_frame", "ms", "program_span", "serving loop",
           "frame_p95_ms", "frame_stream"),
    _entry("h2d.mb_per_frame", "MB", "program_counter", "serving loop",
           "frame_p95_ms", "frame_stream"),
    _entry("forward.host_ms_per_frame", "ms", "program_span",
           "model forward", "poses_per_s", "frame_stream"),
    _entry("device.idle_in_forward_share.infer", "%", "device_trace",
           "device (H100)", "poses_per_s", "frame_stream"),
    _entry("h2d.host_ms_per_step", "ms", "program_span", "train step",
           "train_samples_per_s", "train_b24"),
    _entry("step.prepare.host_ms_per_step", "ms", "program_span",
           "train step", "train_samples_per_s", "train_b24"),
    _entry("step.update.host_ms_per_step", "ms", "program_span",
           "train step", "train_samples_per_s", "train_b24"),
    _entry("device.idle_in_input_share.train", "%", "device_trace",
           "device (H100)", "train_samples_per_s", "train_b24"),
]
