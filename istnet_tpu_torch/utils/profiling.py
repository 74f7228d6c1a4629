"""Tracing and timing, the counterpart of ``istnet_tpu/utils/profiling.py``
in PyTorch's idiom, with JAX's names and units:

- ``trace(log_dir)``: a ``torch.profiler`` context (CPU ops, and the card's
  kernels where there is a card) that writes a Chrome trace
  ``<log_dir>/trace_<pid>_<ns>.pt.trace.json``, viewable in Perfetto or
  ``chrome://tracing``.
- ``timed(fn, *args, iters, warmup)``: mean seconds a call, the device
  synchronised after every call.
- ``parse_trace(log_dir)``: the device-kernel rows of the newest trace
  under ``log_dir``: ``name``, ``dur_us``, ``category``, ``op``, the CPU
  op or ``record_function`` that launched the kernel (the port's own
  kernels launch from their wrappers, outside any op unless a
  ``record_function`` or an autograd Function is around them), and
  ``scope``, the ``record_function`` blocks and program spans around the
  launch (JAX's ``tf_op`` is the name-scope path of the two).
- ``aggregate_ops(rows, key, top, calls)``: the rows summed by a key, per
  call.
- ``cuda_ms`` and ``device_us``: CUDA-event and profiler timings of a
  callable on the card (``chip_smoke.py`` and the tools read them).
- ``rounds_ms``: ms a call over several rounds of back-to-back calls, one
  synchronise a round (``bench_torch.py`` and its tools).
- ``busy_and_span``, ``device_kernels``, ``attribute``, ``attribute_rows``
  and ``print_attribution``: a profile's device busy share, and its device
  time by the program's span (``utils/tracing.py``) and by kind (from the
  profiler's event tree, or from a trace's rows;
  ``tools/profile_{train,fwd}_torch.py``).
"""

from __future__ import annotations

import collections
import contextlib
import gc
import glob
import gzip
import json
import os
import re
import statistics
import time
from typing import Callable

import torch

from istnet_tpu_torch.utils import tracing


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write its Chrome trace under
    ``log_dir``. Yields the ``torch.profiler.profile``."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _sync(out) -> None:
    """Wait for the device that holds the first tensor of ``out``."""
    stack = [out]
    while stack:
        x = stack.pop(0)
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


def timed(fn: Callable, *args, iters: int = 10, warmup: int = 2,
          **kwargs) -> float:
    """Mean seconds a call of ``fn(*args, **kwargs)``, with the device
    synchronised after each call."""
    for _ in range(warmup):
        _sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    for _ in range(iters):
        _sync(fn(*args, **kwargs))
    return (time.perf_counter() - t0) / iters


@contextlib.contextmanager
def no_gc():
    """A timed window without the cyclic garbage collector, as ``timeit``
    keeps it: a process's own heap (some 10^5 tracked objects once the
    profiler has run) makes a full collection a pause of 0.2-0.6 s, which
    would land in whatever host-bound path is being timed."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds a call of ``fn()`` on the card by CUDA events around
    ``iters`` calls after ``warmup``, the collector off."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with no_gc():
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rounds_ms(fn, rounds: int, iters: int, warmup: int = 1,
              device: str | torch.device = "cuda") -> dict:
    """Milliseconds a call of ``fn()`` over ``rounds`` rounds of ``iters``
    back-to-back calls, after ``warmup`` calls, the collector off: on the
    card CUDA events around each round and one synchronise at its end, so
    that nothing inside a round waits for the device; on the CPU (a
    rehearsal, no device time) the host clock. Returns ``{"rounds": [ms a
    call, round by round], "median", "min", "max"}``."""
    on_card = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    per_call = []
    with no_gc():
        for _ in range(rounds):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn()
                end.record()
                end.synchronize()
                per_call.append(start.elapsed_time(end) / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn()
                per_call.append((time.perf_counter() - t0) * 1e3 / iters)
    return {"rounds": per_call, "median": statistics.median(per_call),
            "min": min(per_call), "max": max(per_call)}


def device_us(fn, iters: int = 10) -> dict:
    """Device microseconds a call by kernel name (torch.profiler's device
    events): what the card spends, whatever the host takes to launch it.
    The trace holds ``iters + 1`` calls; the profiler now and then loses
    the first events after its start, so the first call is there to be
    lost. A name's launches a call are its event count over the calls,
    rounded (a lost or a stray event leaves it as it is); its last
    ``iters`` rounds of events, in time order, are its launches of call
    after call; each launch counts with its median over the calls, so that
    one event with a broken time range does not move the reading. A name
    with too few events for that reads NaN."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters + 1):
            fn()
        torch.cuda.synchronize()
    spans: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            m = _KERNEL_NAME.search(e.name)
            name = m.group(0) if m else "other"
            spans.setdefault(name, []).append(
                (e.time_range.start, e.time_range.end - e.time_range.start))
    sums = {}
    for name, events in spans.items():
        per_call = max(1, round(len(events) / (iters + 1)))
        us = [d for _, d in sorted(events)][-per_call * iters:]
        sums[name] = float("nan") if len(us) < per_call * iters else sum(
            statistics.median(us[k::per_call]) for k in range(per_call))
    return sums


# ---------------------------------------------------------------------------
# Chrome-trace parsing (kernel-level attribution)
# ---------------------------------------------------------------------------

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
OP_CATEGORIES = ("cpu_op", "user_annotation")


def _newest_trace(log_dir: str) -> str:
    paths = [p for pattern in ("*.trace.json", "*.trace.json.gz")
             for p in glob.glob(os.path.join(log_dir, "**", pattern),
                                recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no *.trace.json[.gz] under {log_dir}")
    return max(paths, key=os.path.getmtime)


def _in_scope(event: dict) -> bool:
    return (event.get("cat") == "user_annotation"
            or event["name"].startswith(tracing.PREFIX))


def _launching_ops(events: list[dict]) -> dict:
    """Correlation id of each launch -> ``(op, scope)``: the innermost CPU
    op or ``record_function`` around it on its thread, and the names of
    the ``record_function`` blocks and program spans (``utils/tracing.py``)
    around it, outermost first, joined by "/" ("" where there is none)."""
    by_thread: dict = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in OP_CATEGORIES or cat in LAUNCH_CATEGORIES:
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(e)
    out = {}
    for thread in by_thread.values():
        # at equal starts the longer event opens first, launches last
        thread.sort(key=lambda e: (float(e["ts"]),
                                   e.get("cat") in LAUNCH_CATEGORIES,
                                   -float(e.get("dur", 0.0))))
        stack: list = []
        for e in thread:
            ts = float(e["ts"])
            while stack and (float(stack[-1]["ts"])
                             + float(stack[-1].get("dur", 0.0))) < ts:
                stack.pop()
            if e.get("cat") in LAUNCH_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    out[corr] = (stack[-1]["name"] if stack else "",
                                 "/".join(o["name"] for o in stack
                                          if _in_scope(o)))
            else:
                stack.append(e)
    return out


def parse_trace(log_dir: str) -> list[dict]:
    """Device-kernel rows of the newest Chrome trace under ``log_dir``
    (``trace``'s ``*.trace.json``, or a gzipped one): one dict an event,
    ``{name, dur_us, category, op, scope}``, in time order (``op`` and
    ``scope`` as ``_launching_ops`` gives them). CPU-side events and
    annotations on the device's timeline are left out."""
    path = _newest_trace(log_dir)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    ops = _launching_ops(events)
    rows = []
    for e in sorted((e for e in events if e.get("ph") == "X"
                     and e.get("cat") in DEVICE_CATEGORIES),
                    key=lambda e: float(e["ts"])):
        op, scope = ops.get((e.get("args") or {}).get("correlation"),
                            ("", ""))
        rows.append({"name": e.get("name", ""),
                     "dur_us": float(e.get("dur", 0.0)),
                     "category": e.get("cat"), "op": op, "scope": scope})
    return rows


def aggregate_ops(rows: list[dict], key: str = "op", top: int = 30,
                  calls: int = 1) -> list[dict]:
    """Device rows summed by ``key`` (a row without one counts under its
    kernel's name), longest first: ``{key, dur_us, n, category}``, time
    and count per call over ``calls`` identical calls in the trace."""
    agg: dict[str, dict] = {}
    for r in rows:
        k = r.get(key) or r["name"]
        a = agg.setdefault(k, {"key": k, "dur_us": 0.0, "n": 0,
                               "category": r["category"]})
        a["dur_us"] += r["dur_us"]
        a["n"] += 1
    out = sorted(agg.values(), key=lambda a: -a["dur_us"])[:top]
    for a in out:
        a["dur_us"] = round(a["dur_us"] / calls, 1)
        a["n"] = a["n"] // calls or a["n"]
    return out


# ---------------------------------------------------------------------------
# Device time by owner (torch.profiler events)
# ---------------------------------------------------------------------------

REDUCTIONS = ("sum", "mean", "var", "norm", "max", "amax", "min", "std")
_KERNEL_NAME = re.compile(r"[A-Za-z0-9_]*_kernel[A-Za-z0-9_]*")


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


def _spans(evt) -> list[str]:
    """The program's spans (``utils/tracing.py``) around a profiled event,
    innermost first: the ``istnet:`` ranges among it and its CPU
    parents."""
    out = []
    while evt is not None:
        if evt.name.startswith(tracing.PREFIX):
            out.append(evt.name[len(tracing.PREFIX):])
        evt = evt.cpu_parent
    return out


def _kind(op_name: str) -> str:
    name = op_name.removeprefix("aten::")
    if "conv" in name:
        return "convolutions"
    if name in ("mm", "addmm", "bmm", "baddbmm", "matmul", "linear") \
            or name.startswith(("mm_", "addmm_", "bmm_")):
        return "GEMMs"
    if name in ("_to_copy", "copy_", "to"):
        return "casts"
    if name.startswith(REDUCTIONS) or "reduce" in name:
        return "reductions"
    return "elementwise"


def device_kernels(events) -> list:
    """The device activity of a profile's events (kernels, copies,
    memsets): its CUDA events without the device-side copies of
    ``record_function`` ranges, which span the kernels launched in them
    and the gaps between."""
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def kernel_label(kernel_name: str) -> str:
    """A device kernel's short name: its ``*_kernel*`` word (the port's
    kernels are named so), else its first 40 characters."""
    m = _KERNEL_NAME.search(kernel_name)
    return m.group(0) if m else kernel_name[:40]


def attribute(events, use_cpu: bool = False) -> dict:
    """{(phase, owner, kind): us} over ``events`` (a profile of CPU ops
    and device activity): the device time of each kernel (with
    ``use_cpu``, each aten op's self CPU time) under the operation
    that launched it. The owner is the innermost program span
    (``utils/tracing.py``) around the operation, "other" outside them. The
    phase is "backward" under an autograd node, whose owner is that of the
    forward operation that recorded the node (the profiler's sequence
    numbers), "update" inside the span ``step.update`` (Adam and the BN
    EMA), else "forward". The kind comes from the aten operation
    (``_kind``), and a kernel that no aten operation launched (the port's,
    through ctypes) is its own kind, ``"kernel " + kernel_label``, under
    the span it was launched in."""
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    fwd_owner = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            fwd_owner.setdefault(e.sequence_nr, (_spans(e) or [None])[0])
    out = collections.Counter()
    for e in cpu:
        if use_cpu:
            if not e.name.startswith("aten::"):
                continue
            parts = [(_kind(e.name), e.self_cpu_time_total)]
        elif e.name.startswith("aten::"):
            parts = [(_kind(e.name), sum(k.duration for k in e.kernels))]
        else:
            parts = [("kernel " + kernel_label(k.name), k.duration)
                     for k in e.kernels]
        parts = [(kind, us) for kind, us in parts if us]
        if not parts:
            continue
        phase, owner, node = "forward", None, e
        while node is not None:
            if node.name.startswith("autograd::engine::evaluate_function"):
                phase = "backward"
                owner = fwd_owner.get(node.sequence_nr)
                break
            node = node.cpu_parent
        if phase == "forward":
            spans = _spans(e)
            owner = spans[0] if spans else None
            if "step.update" in spans:
                phase = "update"
        for kind, us in parts:
            out[(phase, owner or "other", kind)] += us
    return out


def attribute_rows(rows) -> dict:
    """{("forward", owner, kind): us} over ``parse_trace``'s device rows
    of a forward: each row under the innermost program span
    (``utils/tracing.py``) around its launch (its ``scope``; "other"
    outside them), its kind from the operation that launched it (``_kind``
    of an aten op; a row that no aten op launched, as the port's wrappers
    launch theirs, under its own name, ``"kernel " + kernel_label``). The
    trace links each launch to
    the ranges open on its thread, so every row counts, wherever the
    profiler's event tree would lose it."""
    out = collections.Counter()
    for r in rows:
        owners = [part[len(tracing.PREFIX):] for part in r["scope"].split("/")
                  if part.startswith(tracing.PREFIX)]
        kind = (_kind(r["op"]) if r["op"].startswith("aten::")
                else "kernel " + kernel_label(r["name"]))
        out[("forward", owners[-1] if owners else "other", kind)] += \
            r["dur_us"]
    return out


def print_attribution(table: dict, calls: int, unit: str,
                      per: str = "step") -> float:
    """Print ``attribute``'s table per phase and owner, ms a ``per`` over
    ``calls`` calls by kind, largest first, then the sums by kind; returns
    the attributed ms a call."""
    total = sum(table.values()) / 1e3 / calls
    print(f"[by module] {unit} a {per}: {total:.3f} ms attributed")
    rows = collections.defaultdict(collections.Counter)
    for (phase, owner, kind), us in table.items():
        rows[(phase, owner)][kind] += us
    for (phase, owner), kinds in sorted(rows.items(),
                                        key=lambda kv: -sum(kv[1].values())):
        s = sum(kinds.values())
        parts = ", ".join(f"{k} {v / 1e3 / calls:.3f}"
                          for k, v in kinds.most_common())
        print(f"[by module] {phase:8s} {owner:18s} {s / 1e3 / calls:8.3f} "
              f"ms ({parts})")
    kinds = collections.Counter()
    for (_, _, kind), us in table.items():
        kinds[kind] += us
    print("[by module] by kind: " + ", ".join(
        f"{k} {v / 1e3 / calls:.3f} ms" for k, v in kinds.most_common()))
    return total
