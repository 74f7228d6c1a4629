#!/usr/bin/env python3
"""One run of one benchmark cell of ``istnet_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, its traffic mix and its metrics come from
``BENCHMARK.json`` (see ``benchmark/README.md``). The run builds the
program's kernels (``istnet_tpu_torch/build/<hash>/`` inside the checkout,
built once), makes the weights and the traffic from the seed, warms up the
cell's shapes, measures for ``--seconds``, and with ``--trace 1`` then
profiles a few items for the per-layer metrics. Once the program's state
is freed it checks the window's answers against the plain reference in
``benchmark/reference/``. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(and ``breakdown`` with ``--trace 1``), then ``checks``, the compared
numbers beside their limits, which also end standard error.

Without enough CUDA cards, or with JAX or the JAX package loaded, it
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def build_kernels(device) -> dict:
    """Build (or find built) the program's kernel library; seconds spent."""
    if device.type != "cuda":
        return {"cached": None, "seconds": 0.0}
    from istnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    return {"cached": bool(_build.build_info.get("cached")),
            "seconds": time.perf_counter() - t0,
            "dir": str(_build.BUILD.relative_to(ROOT))}


def per_layer(metrics: list, readings: dict) -> dict:
    from benchmark.harness import manifest
    out = {}
    for m in metrics:
        value = manifest.reader(m["name"]).read(readings)
        if value is None:
            raise RuntimeError(f"per-layer metric {m['name']}: nothing to "
                               f"read in this traced run")
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def dispatch_counts() -> dict:
    """The program's per-kernel launch counters."""
    from istnet_tpu_torch.ops import dispatch
    return dispatch.launch_counts()


def device_allocs(device) -> int:
    """How many times the caching allocator has asked the driver for
    memory."""
    if not _cuda(device):
        return 0
    import torch
    return int(torch.cuda.memory_stats(device).get("num_device_alloc", 0))


def _cuda(device) -> bool:
    return device.type == "cuda"


def main(argv=None) -> int:
    args = parse(argv)
    from benchmark.harness import compare, flops, guard, manifest
    from benchmark.harness.runner import sync
    from benchmark.harness.window import HostReadings, Window

    spec = manifest.load()
    cell = manifest.cell(spec, args.workload)
    cfg = manifest.config(spec, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    limits = manifest.limits(cell["name"])
    device = guard.require_cards(cell["chips"])

    import torch
    built = build_kernels(device)
    log(f"kernels: {json.dumps(built)}")
    runner = manifest.kind(traffic["kind"]).Runner(cfg, traffic, device,
                                                   args.seed)
    runner.setup()
    sync(device)
    setup_s = time.perf_counter() - T_START

    if _cuda(device):
        torch.cuda.reset_peak_memory_stats(device)
    window = Window(args.seconds)
    launches = dispatch_counts()
    allocs = device_allocs(device)
    with HostReadings() as host:
        e2e = runner.run(window)
    launches = {k: v - launches.get(k, 0) for k, v in dispatch_counts().items()}
    allocs = device_allocs(device) - allocs
    peak = torch.cuda.max_memory_allocated(device) if _cuda(device) else 0
    e2e["setup_s"] = setup_s
    readings = {**runner.readings(), "window_s": window.length,
                "counts": dict(runner.counts), "cfg": cfg,
                "flops_forward": flops.forward(cfg),
                "flops_train_sample": flops.train_sample(cfg)}
    log(f"window: {json.dumps(runner.counts)} in {window.length!r} s; "
        f"build {built['seconds']!r} s; setup {setup_s!r} s "
        f"{json.dumps(getattr(runner, 'setup_parts', {}))}; "
        f"end-to-end {json.dumps(e2e)}; launches in the window "
        f"{json.dumps(launches)}; peak {peak} bytes; rate by half "
        f"{json.dumps(window.halves())}; device allocations {allocs}; host "
        f"{json.dumps(host.readings)}")

    metric_specs = manifest.metrics_of(spec, cell["name"], bool(args.trace))
    result_device = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device) if _cuda(device) else "cpu",
        "count": cell["chips"], "memory_peak_bytes": peak,
        "power_limit_w": power_limit_w() if _cuda(device) else None}
    breakdown = None
    if args.trace:
        metrics, breakdown = traced(runner, readings, metric_specs,
                                    result_device)
    else:
        metrics = {m["name"]: {"value": float(e2e[m["name"]]),
                               "unit": m["unit"]} for m in metric_specs}

    runner.free()
    verdict = compare.Verdict(limits)
    runner.check(verdict)
    guard.check_no_jax()
    result = {"correct": verdict.correct,
              "attempted": runner.counts["attempted"], "failed": 0,
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = verdict.as_dict()
    for line in verdict.lines():
        log(line)
    print(json.dumps(result), flush=True)
    return 0


def traced(runner, readings: dict, metric_specs: list, result_device: dict):
    """Profile the runner's traced items; the per-layer metrics and the
    breakdown."""
    from benchmark.harness import roofline
    from benchmark.harness.trace import Trace, device_window, span
    from istnet_tpu_torch.ops import dispatch

    meter = roofline.KernelMeter()

    @contextlib.contextmanager
    def window():
        with span("window"), meter:
            yield

    before = dispatch.launch_counts()
    with Trace.capture() as box:
        counts = runner.trace(window)
    trace = box[0]
    kernels = roofline.kernel_names()
    calls = sum(meter.calls.values())
    if trace.kernel_count(kernels) < calls:
        raise RuntimeError(f"the trace lost device events: "
                           f"{trace.kernel_count(kernels)} kernel launches "
                           f"seen for {calls} kernel calls")
    after = dispatch.launch_counts()
    busy = {}
    runner.trace(device_window(busy))
    readings.update(trace=trace, traced=counts, kernels=kernels,
                    least_ms=meter.finish(), busy_s=busy["busy_s"],
                    span_s=busy["span_s"])
    metrics = per_layer(metric_specs, readings)
    result_device.update(busy_s=busy["busy_s"], window_s=busy["window_s"])
    log(f"trace: {len(trace.device)} device "
        f"operations; traced {json.dumps(counts)}; kernel calls "
        f"{json.dumps(meter.calls)}; launches "
        f"{json.dumps({k: after[k] - before[k] for k in after})}; least "
        f"{readings['least_ms']!r} ms, port kernels "
        f"{trace.kernels_ms(kernels)!r} ms (bytes alone: "
        f"{sorted(meter.bytes_only)}); with host events busy "
        f"{trace.busy_and_span_s()!r} s of span, window {trace.window_s!r} "
        f"s; device alone {json.dumps(busy)}")
    return metrics, trace.breakdown(kernels)


if __name__ == "__main__":
    os.environ.setdefault("USE_FLAX", "0")
    sys.exit(main())
