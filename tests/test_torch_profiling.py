"""The port's tracing helpers (``utils/profiling.py``): ``parse_trace`` and
``aggregate_ops`` on a written Chrome trace in torch.profiler's format, a
trace that ``trace`` writes, and ``timed`` on the CPU."""

import gzip
import json
import os

import pytest
import torch

from istnet_tpu_torch.utils import profiling


def _x(cat, name, ts, dur, pid=1, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    return [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "python"}},
        # host thread 1: a record_function around an aten op that launches
        # a kernel, and a launch of the port's own kernel outside any op
        _x("user_annotation", "encoder", 0, 100),
        _x("cpu_op", "aten::conv2d", 10, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 20, 5, corr=7),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 5, corr=8),
        _x("cuda_runtime", "cudaLaunchKernel", 200, 5, corr=9),
        # host thread 2: another op launching twice
        _x("cpu_op", "aten::add", 300, 20, tid=2),
        _x("cuda_runtime", "cudaLaunchKernel", 305, 3, tid=2, corr=10),
        _x("cuda_runtime", "cudaLaunchKernel", 310, 3, tid=2, corr=11),
        # the device's timeline (stream 7): the kernels and a memset, and
        # an annotation that is no kernel
        _x("kernel", "void conv_fwd<float>(...)", 30, 50.0, pid=0, tid=7,
           corr=7),
        _x("kernel", "void istnet::fps_kernel<8, 2>(float const*)", 90,
           12.5, pid=0, tid=7, corr=8),
        _x("kernel", "void istnet::fps_kernel<8, 2>(float const*)", 210,
           12.5, pid=0, tid=7, corr=9),
        _x("gpu_memset", "Memset (Device)", 320, 1.0, pid=0, tid=7,
           corr=10),
        _x("kernel", "elementwise_add", 330, 4.0, pid=0, tid=7, corr=11),
        _x("gpu_user_annotation", "encoder", 30, 80, pid=0, tid=7),
    ]


def _write(tmp_path, name, events, gz=False):
    d = tmp_path / "sub"
    d.mkdir(exist_ok=True)
    path = d / name
    if gz:
        with gzip.open(path, "wt") as f:
            json.dump({"traceEvents": events}, f)
    else:
        path.write_text(json.dumps({"traceEvents": events}))
    return str(tmp_path)


@pytest.mark.parametrize("gz", [False, True])
def test_parse_trace_keeps_device_kernels_with_their_op(tmp_path, gz):
    name = "x.pt.trace.json" + (".gz" if gz else "")
    rows = profiling.parse_trace(_write(tmp_path, name, _events(), gz))
    assert [(r["name"], r["dur_us"], r["op"], r["scope"], r["category"])
            for r in rows] == [
        ("void conv_fwd<float>(...)", 50.0, "aten::conv2d", "encoder",
         "kernel"),
        ("void istnet::fps_kernel<8, 2>(float const*)", 12.5, "encoder",
         "encoder", "kernel"),
        ("void istnet::fps_kernel<8, 2>(float const*)", 12.5, "", "",
         "kernel"),
        ("Memset (Device)", 1.0, "aten::add", "", "gpu_memset"),
        ("elementwise_add", 4.0, "aten::add", "", "kernel"),
    ]


def test_parse_trace_reads_the_newest(tmp_path):
    _write(tmp_path, "old.pt.trace.json", _events()[:3])
    newest = os.path.join(_write(tmp_path, "new.pt.trace.json", _events()),
                          "sub", "new.pt.trace.json")
    os.utime(newest, (2e9, 2e9))
    assert len(profiling.parse_trace(str(tmp_path))) == 5
    with pytest.raises(FileNotFoundError):
        profiling.parse_trace(str(tmp_path / "none"))


def test_aggregate_ops(tmp_path):
    rows = profiling.parse_trace(_write(tmp_path, "t.pt.trace.json",
                                        _events()))
    by_op = profiling.aggregate_ops(rows, key="op")
    assert [(a["key"], a["dur_us"], a["n"]) for a in by_op] == [
        ("aten::conv2d", 50.0, 1),
        ("encoder", 12.5, 1),
        ("void istnet::fps_kernel<8, 2>(float const*)", 12.5, 1),
        ("aten::add", 5.0, 2)]
    by_name = profiling.aggregate_ops(rows, key="name", calls=2, top=2)
    assert [(a["key"], a["dur_us"], a["n"]) for a in by_name] == [
        ("void conv_fwd<float>(...)", 25.0, 1),
        ("void istnet::fps_kernel<8, 2>(float const*)", 12.5, 1)]


def test_trace_writes_what_parse_trace_reads(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("mine"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = [f for f in os.listdir(tmp_path) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "mine" in names
    # the CPU has no device kernels
    assert profiling.parse_trace(str(tmp_path)) == []


def test_timed_is_mean_seconds_a_call():
    calls = []
    seconds = profiling.timed(lambda x: calls.append(x) or torch.ones(2), 3,
                              iters=4, warmup=1)
    assert calls == [3] * 5 and 0 <= seconds < 1.0
