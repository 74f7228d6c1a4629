"""Named spans and counters inside the program, on the profiler's clock.

- ``span(name, item=None)``: a context manager around one part of the
  program's work. With no profiler running (``torch.profiler.profile``,
  ``torch.autograd.profiler.profile``, ``utils.profiling.trace``) it
  returns one shared no-op context and records nothing: the whole cost is
  a check of the profiler's flag and a ``with``. With a profiler running it
  opens the profiler range ``istnet:<name>``, which lands in the profile
  and in its Chrome trace, and keeps a ``Span(name, start_ns, end_ns,
  parent, item)`` record in a ring of the last ``RING`` spans.
  ``start_ns`` / ``end_ns`` are ``time.time_ns()`` just after the range
  opens and closes, on the Unix clock that the profiler's events
  (``KinetoEvent.start_ns()``) are on; ``parent`` is the enclosing span's
  index in ``records()`` (-1 for none); ``item`` is the frame or train
  step the span belongs to, given by the outermost span (``serve``,
  ``step``) and taken by every span inside it.
- The range is a CPU event of the profiler's fast record function, not a
  ``record_function`` user annotation: the profiler copies to the device's
  timeline only the innermost user annotation around a kernel, so the
  program's spans as user annotations would take the device-side ranges
  of any caller's ``record_function`` around the program.
- ``count(name, n=1)``: a host integer, always on; it never reads a device
  value and never synchronises. Returns the new count.
- ``records()``, ``counters()``: copies, the records of finished spans in
  the order they opened. ``reset()`` empties the ring and the counters.

Nothing is written to disk and nothing runs on the device. The spans and
counters of the program, and what reads them, are listed in ``PERF.md``
(section 3). Spans are opened on the thread that drives the program; the
parent of a span is the innermost span open on its own thread.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

PREFIX = "istnet:"
RING = 1 << 16

_RANGE = torch._C._profiler._RecordFunctionFast

Span = collections.namedtuple("Span", "name start_ns end_ns parent item")

_OFF = contextlib.nullcontext()
_ring: list = [None] * RING      # [id, name, start_ns, end_ns, parent id, item]
_ids = itertools.count()
_open = threading.local()
_counts: dict = {}
_counting = threading.Lock()


def span(name: str, item=None):
    """The span ``name`` around a block (see the module's docstring)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Recorded(name, item)


class _Recorded:
    __slots__ = ("name", "item", "rec", "rf")

    def __init__(self, name: str, item):
        self.name, self.item = name, item

    def __enter__(self):
        stack = _stack()
        parent = stack[-1] if stack else None
        item = self.item
        if item is None and parent is not None:
            item = parent[5]
        rid = next(_ids)
        self.rec = rec = [rid, self.name, 0, None,
                          -1 if parent is None else parent[0], item]
        _ring[rid % RING] = rec
        stack.append(rec)
        self.rf = _RANGE(PREFIX + self.name)
        self.rf.__enter__()
        rec[2] = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        self.rec[3] = time.time_ns()
        _stack().pop()
        return False


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the counter ``name``; returns its new value."""
    with _counting:
        value = _counts[name] = _counts.get(name, 0) + n
    return value


def host_bytes(arrays) -> int:
    """Bytes of ``arrays`` that sit in host memory (numpy arrays, CPU
    tensors, sequences): what a copy to a card moves. Tensors on a card
    count nothing."""
    total = 0
    for a in arrays:
        if isinstance(a, torch.Tensor):
            if a.device.type == "cpu":
                total += a.numel() * a.element_size()
        else:
            total += np.asarray(a).nbytes
    return total


def records() -> list[Span]:
    """The finished spans still in the ring, in the order they opened."""
    done = sorted((r for r in _ring if r is not None and r[3] is not None),
                  key=lambda r: r[0])
    at = {r[0]: i for i, r in enumerate(done)}
    return [Span(r[1], r[2], r[3], at.get(r[4], -1), r[5]) for r in done]


def counters() -> dict:
    return dict(_counts)


def reset() -> None:
    """Empty the ring and the counters (spans open now keep their place
    on their thread's stack, outside the ring)."""
    _ring[:] = [None] * RING
    with _counting:
        _counts.clear()
