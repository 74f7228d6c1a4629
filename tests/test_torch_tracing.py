"""The program's spans and counters (``istnet_tpu_torch/utils/tracing.py``)
on the CPU at tiny shapes: nothing recorded with the profiler off; with it
on, one record a span, nested as the code nests, on the clock of the
profiler's own ranges; the ring bounded; the counters; and the spans that
one serving call and one train step open."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from istnet_tpu_torch.utils import tracing

TINY, IMG, NPTS = (32, 16, 8, 8), 48, 128


@pytest.fixture(autouse=True)
def _empty():
    tracing.reset()
    yield
    tracing.reset()


def _profiled(fn):
    """``fn()`` under the profiler; ``(its records, the profiler's istnet:
    ranges as {name: [(start_ns, end_ns)]})``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith(tracing.PREFIX):
            ranges.setdefault(e.name()[len(tracing.PREFIX):], []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return tracing.records(), ranges


def _tree(recs) -> dict:
    """{span name: set of its parents' names} over the records."""
    out = {}
    for r in recs:
        out.setdefault(r.name, set()).add(
            recs[r.parent].name if r.parent >= 0 else None)
    return out


def test_off_records_nothing_and_leaves_no_range():
    assert tracing.span("a") is tracing.span("b", item=3)
    with tracing.span("a"):
        with tracing.span("b"):
            torch.ones(4).sum()
    assert tracing.records() == []
    _, ranges = _profiled(lambda: torch.ones(4).sum())
    assert ranges == {}
    assert tracing.records() == []


def test_on_one_record_a_span_with_its_parent_item_and_range():
    def work():
        with tracing.span("warm"):      # the profiler's first range is slow
            pass
        for item in (7, 8):
            with tracing.span("outer", item=item):
                torch.ones(64).sum()
                with tracing.span("inner"):
                    torch.ones(64).mul(2)
                with tracing.span("inner"):
                    pass
        with tracing.span("loose"):
            pass

    recs, ranges = _profiled(work)
    assert [r.name for r in recs] == ["warm", "outer", "inner", "inner",
                                      "outer", "inner", "inner", "loose"]
    assert [r.item for r in recs] == [None, 7, 7, 7, 8, 8, 8, None]
    assert [r.parent for r in recs] == [-1, -1, 1, 1, -1, 4, 4, -1]
    for r in recs:
        assert r.start_ns <= r.end_ns
        if r.parent >= 0:
            p = recs[r.parent]
            assert p.start_ns <= r.start_ns and r.end_ns <= p.end_ns
    for name in ("outer", "inner", "loose"):
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs)
        for (s0, e0), (s1, e1) in zip(mine, theirs):
            assert abs(s0 - s1) < 50_000 and abs(e0 - e1) < 50_000, name


def test_the_ring_keeps_the_last_spans(monkeypatch):
    assert len(tracing._ring) == tracing.RING == 1 << 16
    monkeypatch.setattr(tracing, "RING", 8)
    monkeypatch.setattr(tracing, "_ring", [None] * 8)

    def work():
        with tracing.span("outer", item=1):
            for i in range(20):
                with tracing.span(f"s{i}"):
                    pass

    recs, _ = _profiled(work)
    # 21 spans opened: the last 8 stay; "outer" fell out, so its children
    # have no parent left
    assert [r.name for r in recs] == [f"s{i}" for i in range(12, 20)]
    assert all(r.parent == -1 and r.item == 1 for r in recs)
    assert len(tracing._ring) == 8


def test_counters_add_up_and_reset():
    assert tracing.count("a") == 1
    assert tracing.count("a", 4) == 5
    tracing.count("b", 2)
    c = tracing.counters()
    c["a"] = 0                               # a copy
    assert tracing.counters() == {"a": 5, "b": 2}
    arrays = (np.zeros((3, 5), np.float32), torch.zeros(2, 2, dtype=torch.int64),
              [1, 2], np.zeros(4, bool))
    assert tracing.host_bytes(arrays) == 60 + 32 + np.asarray([1, 2]).nbytes + 4
    tracing.reset()
    assert tracing.counters() == {} and tracing.records() == []


def test_a_serving_call_opens_its_spans_and_counts_its_bytes():
    from istnet_tpu_torch.entry import build_device_forward, make_frame
    from istnet_tpu_torch.nn import precision

    old = precision.compute_dtype()
    try:
        _, fn = build_device_forward(torch.float32, "cpu", 3, TINY, IMG, NPTS)
        fr = make_frame(12, 3)
        args = (fr["rgb_full"], fr["depth_raw"], fr["masks"], fr["bboxes"],
                fr["category_label"])
        v = torch.rand(3, NPTS, generator=torch.Generator().manual_seed(2))
        fn(*args, v=v)                       # off: counted, not recorded
        assert tracing.records() == []
        recs, ranges = _profiled(lambda: fn(*args, v=v))
    finally:
        precision.set_compute_dtype(old)
    frame_bytes = sum(np.asarray(a).nbytes for a in args)
    assert tracing.counters() == {"serve.frames": 2,
                                  "h2d.bytes": 2 * frame_bytes}
    tree = _tree(recs)
    assert tree["serve"] == {None}
    for name in ("h2d", "fill", "preprocess", "forward"):
        assert tree[name] == {"serve"}, name
    for name in ("forward.rgb", "forward.points", "forward.transform",
                 "forward.estimate"):
        assert tree[name] == {"forward"}, name
    for name in ("sa1", "sa2", "sa3", "sa4", "fp1", "fp2", "fp3", "fp4"):
        assert tree[name] == {"forward.points"}, name
    for name in ("feats", "psp", "up_1", "up_2", "up_3"):
        assert tree[name] == {"forward.rgb"}, name
    assert "forward.cam_enhancer" not in tree
    assert {r.item for r in recs} == {1}     # the second call
    assert set(ranges) == set(tree)
    serve = next(r for r in recs if r.name == "serve")
    inside = sum(r.end_ns - r.start_ns for r in recs if r.parent >= 0
                 and recs[r.parent].name == "serve")
    assert 0.5 * (serve.end_ns - serve.start_ns) < inside <= (
        serve.end_ns - serve.start_ns)


def test_a_train_step_opens_its_spans_with_bn_under_the_forward():
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train import solver
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)

    model = build_train_model("cpu", seed=1, sa_npoints=TINY)
    cfg = TrainConfig()
    opt = make_optimizer(model, cfg)
    gen = torch.Generator().manual_seed(1)
    batch = make_train_batch(2, 64, IMG, seed=1, device="cpu")
    host = {part: {k: v.numpy() for k, v in leaves.items()}
            for part, leaves in batch.items()}
    nbytes = sum(a.nbytes for leaves in host.values() for a in leaves.values())

    def work():
        train_step(model, opt, solver.to_device(host, torch.device("cpu"),
                                                torch.float32),
                   5, gen, cfg)

    recs, ranges = _profiled(work)
    assert tracing.counters() == {"h2d.bytes": nbytes}
    tree = _tree(recs)
    assert tree["h2d"] == {None} and tree["step"] == {None}
    for name in ("step.prepare", "step.start", "step.loss", "step.backward",
                 "step.update"):
        assert tree[name] == {"step"}, name
    assert tree["forward"] == {"step.loss"}
    assert tree["adam"] == tree["bn_ema"] == {"step.update"}
    assert tree["forward.cam_enhancer"] == {"forward"}
    assert tree["forward.world_enhancer"] == {"forward"}
    assert tree["sa1"] == {"forward.points", "forward.world_enhancer"}
    assert {"feats", "up_1", "up_3", "sa1", "fp1"} <= tree["bn"]
    bns = [r for r in recs if r.name == "bn"]
    n_bn = sum(type(m).__name__ == "BatchNorm" for m in model.modules())
    assert len(bns) >= n_bn
    for r in bns:                            # every bn under the forward
        p = r.parent
        while recs[p].name != "forward":
            p = recs[p].parent
            assert p >= 0
    assert {r.item for r in recs if r.name != "h2d"} == {5}
    assert recs[0].name == "h2d" and recs[0].item is None
    assert set(ranges) == set(tree)


class _Loader:
    """Two copies of one flat batch, as a loader yields them."""

    def __init__(self, flat):
        self.flat, self.batch_size, self.dataset = flat, 2, None

    def __len__(self):
        return 2

    def __iter__(self):
        return iter([self.flat, self.flat])


def test_the_solver_spans_its_data_wait(tmp_path):
    """``Solver.train_epoch`` opens ``solver.data`` around each fetch and
    handover (``h2d`` inside), where ``T_data`` measures it, then the
    step."""
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.solver import Solver, split_batch
    from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
    from istnet_tpu_torch.utils.config import Config

    model = build_train_model("cpu", seed=1, sa_npoints=TINY)
    cfg = TrainConfig()
    b = make_train_batch(2, 64, IMG, seed=1, device="cpu")
    flat = {k: v.numpy() for part in b.values() for k, v in part.items()}
    solver = Solver(model, make_optimizer(model, cfg), cfg,
                    Config({"max_epoch": 1, "num_mini_batch_per_epoch": 2,
                            "per_write": 100}),
                    syn_loader=_Loader(flat), log_dir=str(tmp_path))
    records = []
    recs, _ = _profiled(lambda: records.extend(solver.train_epoch(1)))
    top = [r for r in recs if r.parent == -1]
    assert [r.name for r in top] == ["solver.data", "step"] * 2 + [
        "solver.data"]
    assert [r.item for r in top if r.name == "step"] == [0, 1]
    tree = _tree(recs)
    assert tree["h2d"] == {"solver.data"}
    assert tracing.counters()["h2d.bytes"] == 2 * sum(
        a.nbytes for part in split_batch(flat).values()
        for a in part.values())
    for rec, span in zip(records, [r for r in top if r.name == "solver.data"]):
        assert (span.end_ns - span.start_ns) * 1e-9 <= rec["T_data"]


def test_a_trace_scopes_a_launch_by_the_spans_around_it():
    """``parse_trace``'s scope of a launch holds the program's spans (CPU
    events of the profiler, not user annotations) beside the
    ``record_function`` blocks around it."""
    from istnet_tpu_torch.utils import profiling

    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "pid": 1, "tid": 1, "args": args}

    events = [x("bench:forward", "user_annotation", 0, 100),
              x("istnet:forward", "cpu_op", 1, 98),
              x("istnet:sa1", "cpu_op", 2, 40),
              x("aten::mm", "cpu_op", 3, 10),
              x("cudaLaunchKernel", "cuda_runtime", 4, 2, correlation=7),
              x("cudaLaunchKernel", "cuda_runtime", 20, 2, correlation=8)]
    assert profiling._launching_ops(events) == {
        7: ("aten::mm", "bench:forward/istnet:forward/istnet:sa1"),
        8: ("istnet:sa1", "bench:forward/istnet:forward/istnet:sa1")}
