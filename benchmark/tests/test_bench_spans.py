"""The readers of the program's own spans and counters
(``harness/spans.py``, ``metrics/*``): the window, host and self time, the
device's idle time integrated under the innermost span, each reader on a
synthetic traced run; on the card, the spans against their profiler
ranges and short traced runs of the two cells the readers are for.

    python -m pytest -m gpu -s benchmark/tests/test_bench_spans.py
"""

import io
import json
import math
import statistics
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from benchmark.harness import manifest, spans
from benchmark.harness.trace import merged
from istnet_tpu_torch.utils import tracing
from istnet_tpu_torch.utils.tracing import Span

FRAMES = [
    Span("early", -50, 20, -1, None),          # starts before the window
    Span("serve", 100, 500, -1, 0),
    Span("h2d", 110, 150, 1, 0),
    Span("forward", 200, 480, 1, 0),
    Span("sa1", 250, 300, 3, 0),
    Span("serve", 600, 900, -1, 1),
    Span("forward", 650, 850, 5, 1),
    Span("late", 1100, 1200, -1, None),         # ends after the window
]
# gaps: 120-140 in h2d; 260-290 in sa1; 320-480 in forward; 620-700 in
# serve then forward; 950-990 outside every span
FRAME_BUSY = [(0, 120), (140, 260), (290, 320), (480, 620), (700, 950),
              (930, 940), (990, 1000)]

STEPS = [
    Span("h2d", 100, 200, -1, None),
    Span("step", 210, 800, -1, 3),
    Span("step.prepare", 220, 400, 1, 3),
    Span("step.loss", 410, 600, 1, 3),
    Span("forward", 420, 590, 3, 3),
    Span("step.update", 620, 780, 1, 3),
    Span("adam", 630, 700, 5, 3),
]
# gaps: 150-160 in h2d; 250-300 in step.prepare; 450-460 in forward
STEP_BUSY = [(0, 150), (160, 250), (300, 450), (460, 1000)]


def test_the_window_keeps_the_spans_inside_it():
    s = spans.Spans(FRAMES, (0, 1000))
    assert [s.records[i][0] for i in s.inside] == [
        "serve", "h2d", "forward", "sa1", "serve", "forward"]
    assert list(s.chain(4)) == ["sa1", "forward", "serve"]


def test_host_and_self_time():
    s = spans.Spans(FRAMES, (0, 1000))
    assert s.host_ms("h2d", under="serve") == pytest.approx(40e-6)
    assert s.host_ms("forward") == pytest.approx((280 + 200) * 1e-6)
    assert s.host_ms("h2d", under="step") is None
    assert s.host_ms("fill") is None
    assert s.self_ms() == pytest.approx({
        "serve": (400 - 40 - 280 + 300 - 200) * 1e-6,
        "h2d": 40e-6, "forward": (280 - 50 + 200) * 1e-6, "sa1": 50e-6})


def test_idle_time_goes_to_the_innermost_span_over_each_gap():
    s = spans.Spans(FRAMES, (0, 1000))
    idle = s.idle_ns(FRAME_BUSY)
    by_name = {}
    for i, ns in idle.items():
        name = None if i is spans.OUTSIDE else s.records[i][0]
        by_name[name] = by_name.get(name, 0) + ns
    # the gap 620-700 straddles serve (to 650) and its forward; 950-990
    # falls outside every span
    assert by_name == {"h2d": 20, "sa1": 30, "forward": 160 + 50,
                       "serve": 30, None: 40}
    assert sum(idle.values()) == 20 + 30 + 160 + 80 + 40
    assert s.idle_share(FRAME_BUSY, ("forward",)) == pytest.approx(
        100 * (30 + 160 + 50) / 330)
    assert s.idle_share(FRAME_BUSY, ("h2d",)) == pytest.approx(100 * 20 / 330)
    assert s.idle_share(FRAME_BUSY, ("step.prepare",)) is None
    # one busy interval over the whole window: no idle to share
    assert s.idle_share([(0, 1000)], ("forward",)) == 0.0


def test_a_gap_past_the_window_is_clipped_to_it():
    s = spans.Spans(FRAMES, (0, 1000))
    idle = s.idle_ns([(0, 120), (140, 960), (1100, 1200)])
    assert sum(idle.values()) == 20 + 40
    assert idle[spans.OUTSIDE] == 40


class _Trace:
    def __init__(self, busy, window=(0, 1000)):
        self.window, self._busy = window, busy

    def in_window(self):
        lo, hi = self.window
        return [(max(s, lo), min(e, hi), "op") for s, e in self._busy
                if e > lo and s < hi]


@pytest.fixture
def program(monkeypatch):
    """The program's records and counters replaced by the test's."""
    state = {"records": [], "counters": {}}
    monkeypatch.setattr(tracing, "records", lambda: list(state["records"]))
    monkeypatch.setattr(tracing, "counters", lambda: dict(state["counters"]))
    return state


FRAME_READS = {
    "h2d.host_ms_per_frame": 40e-6 / 2,
    "h2d.mb_per_frame": 4.0,
    "forward.host_ms_per_frame": 480e-6 / 2,
    "device.idle_in_forward_share.infer": 100 * 240 / 330,
}
STEP_READS = {
    "h2d.host_ms_per_step": 100e-6,
    "step.prepare.host_ms_per_step": 180e-6,
    "step.update.host_ms_per_step": 160e-6,
    "device.idle_in_input_share.train": 100 * 60 / 70,
}


@pytest.mark.parametrize("name,want", [*FRAME_READS.items(),
                                       *STEP_READS.items()])
def test_each_reader_on_a_synthetic_run(program, name, want):
    frames = name in FRAME_READS
    program["records"] = FRAMES if frames else STEPS
    program["counters"] = ({"serve.frames": 10, "h2d.bytes": 40_000_000}
                           if frames else {"h2d.bytes": 5})
    r = {"trace": _Trace(FRAME_BUSY if frames else STEP_BUSY),
         "traced": {"items": 2 if frames else 1, "units": 7}}
    assert manifest.reader(name).read(r) == pytest.approx(want)


@pytest.mark.parametrize("name", [*FRAME_READS, *STEP_READS])
def test_a_reader_has_nothing_to_read_without_the_spans(program, monkeypatch,
                                                        name):
    """No span of the metric's name in the window, or no tracing module
    at all."""
    program["records"] = [Span("other", 100, 200, -1, None),
                          Span("forward", 900, 1100, -1, None),
                          Span("h2d", 950, 1050, 1, None)]
    r = {"trace": _Trace([(0, 100), (200, 300)]),
         "traced": {"items": 1, "units": 1}}
    if name != "h2d.mb_per_frame":
        assert manifest.reader(name).read(r) is None
    monkeypatch.setattr(spans, "program", lambda: None)
    assert manifest.reader(name).read(r) is None


def test_the_entries_name_their_readers_layers_and_cells():
    spec = manifest.load()
    layers = {m["layer"] for m in spec["per_layer"]}
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert {m["name"] for m in spans.METRICS} == set(FRAME_READS) | set(
        STEP_READS)
    for m in spans.METRICS:
        assert manifest.reader(m["name"]).read
        assert m["layer"] in layers and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]]["workloads"]


# -- on the card -------------------------------------------------------------


def _ranges(prof) -> dict:
    out = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CPU
                and e.name().startswith(tracing.PREFIX)):
            out.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


@pytest.mark.gpu
def test_spans_agree_with_their_profiler_ranges_on_the_card(card):
    """Every span of a serving call at full size, and its ``istnet:``
    range in a CPU and CUDA profile, start and end within 50 us; a
    caller's ``record_function`` around the call keeps its device-side
    range (the spans are no user annotations)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from istnet_tpu_torch.entry import build_device_forward, make_frame
    from istnet_tpu_torch.nn import precision

    old = precision.compute_dtype()
    try:
        _, fn = build_device_forward(torch.bfloat16, card)
        fr = make_frame(3, 6)
        args = (fr["rgb_full"], fr["depth_raw"], fr["masks"], fr["bboxes"],
                fr["category_label"])
        for _ in range(2):
            fn(*args)
        torch.cuda.synchronize(card)
        tracing.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                with record_function("bench:outer"):
                    fn(*args)
            torch.cuda.synchronize(card)
    finally:
        precision.set_compute_dtype(old)
    recs, ranges = tracing.records(), _ranges(prof)
    outer = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "bench:outer"
             and e.device_type() == torch.autograd.DeviceType.CUDA]
    print(f"device-side bench:outer ranges: {len(outer)}")
    assert len(outer) >= 3
    assert len(recs) == sum(len(v) for v in ranges.values()) > 3 * 30
    worst = 0
    for name, theirs in ranges.items():
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        assert len(mine) == len(theirs), name
        for (s0, e0), (s1, e1) in zip(mine, sorted(theirs)):
            worst = max(worst, abs(s0 - s1), abs(e0 - e1))
    print(f"spans: {len(recs)} records, worst start or end gap "
          f"{worst / 1e3:.1f} us")
    assert worst < 50_000


FRAME_KEYS = ("rgb_full", "depth_raw", "masks", "bboxes", "category_label")


def _frame_bytes(f) -> int:
    return sum(np.asarray(f[k]).nbytes for k in FRAME_KEYS)


def _served(runner, monkeypatch) -> dict:
    """The bytes of each frame the runner hands the program, and the mean
    over its pool (MB)."""
    state = {"served": [], "pool_mb": None}
    serve = runner._serve

    def wrapped(self, i):
        if state["pool_mb"] is None:
            state["pool_mb"] = statistics.fmean(
                _frame_bytes(f) for f in self.pool) / 1e6
        state["served"].append(_frame_bytes(self.pool[i]))
        return serve(self, i)
    monkeypatch.setattr(runner, "_serve", wrapped)
    return state


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["istnet_r18_n1024.frame_stream",
                                  "istnet_r18_n1024.train_b24"])
def test_a_traced_run_reads_the_span_metrics(card, monkeypatch, cell):
    """A short ``--trace 1`` run of the cell with ``spans.METRICS`` listed:
    its four span metrics read, ``correct``; the program's spans cover 90%
    of the harness's own range around each item; the bytes a frame are
    those of the frames served."""
    from benchmark import run

    load = manifest.load
    monkeypatch.setattr(manifest, "load", lambda path=manifest.MANIFEST: {
        **load(path), "per_layer": load(path)["per_layer"] + spans.METRICS})
    seen, served = {}, None
    per_layer = run.per_layer

    def reading(metrics, readings):
        seen.update(readings)
        return per_layer(metrics, readings)
    monkeypatch.setattr(run, "per_layer", reading)
    kind = manifest.kind(manifest.traffic(manifest.cell(
        manifest.load(), cell)["traffic"])["kind"])
    if "frame" in cell:
        served = _served(kind.Runner, monkeypatch)
    tracing.reset()
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", cell, "--seed", str(2**31 + 11),
                         "--seconds", "4", "--trace", "1"]) == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    mine = [m["name"] for m in spans.METRICS if cell in m["workloads"]]
    assert len(mine) == 4
    values = {k: result["metrics"][k]["value"] for k in mine}
    assert all(math.isfinite(v) and v >= 0 for v in values.values())
    for k, v in values.items():
        if "share" in k:
            assert 0.0 <= v <= 100.0, k

    s = spans.Spans.of(seen)
    lo, hi = seen["trace"].window
    harness = "bench:serve" if "frame" in cell else "bench:step"
    outer = sum(e - b for b, e, n in seen["trace"].host_ranges
                if n == harness and lo <= b and e <= hi)
    parts = (("h2d", "fill", "preprocess", "forward") if "frame" in cell
             else ("h2d", "step"))
    covered = sum(s.host_ms(p) or 0.0 for p in parts) * 1e6
    idle = s.idle_ns(spans.device_busy(seen))
    by_span = {}
    for i, ns in idle.items():
        key = "outside" if i is spans.OUTSIDE else s.records[i][0]
        by_span[key] = by_span.get(key, 0) + ns
    busy = merged(spans.device_busy(seen))
    longest = []
    for g0, g1 in sorted(zip((b[1] for b in busy), (b[0] for b in busy[1:])),
                         key=lambda g: g[0] - g[1])[:10]:
        parts = s.idle_ns([(g0 - 1, g0), (g1, g1 + 1)])
        owner = max(parts, key=parts.get)
        longest.append(["outside" if owner is spans.OUTSIDE
                        else "/".join(reversed(list(s.chain(owner)))),
                        (g1 - g0) * 1e-6])
    report = {"cell": cell, "metrics": values, "longest_gaps_ms": longest,
              "coverage": covered / outer,
              "host_self_ms_per_item": {
                  k: v / seen["traced"]["items"]
                  for k, v in sorted(s.self_ms().items(),
                                     key=lambda kv: -kv[1])[:12]},
              "idle_ms_by_span": {k: v * 1e-6 for k, v in sorted(
                  by_span.items(), key=lambda kv: -kv[1])[:12]},
              "idle_ms": sum(idle.values()) * 1e-6}
    if served:
        report["served_mb_per_frame"] = statistics.fmean(
            served["served"]) / 1e6
        report["pool_mb_per_frame"] = served["pool_mb"]
        assert values["h2d.mb_per_frame"] == pytest.approx(
            report["served_mb_per_frame"], rel=1e-9)
    print("spans report: " + json.dumps(report))
    assert covered >= 0.9 * outer, report
