#!/usr/bin/env python3
"""Profile the PyTorch port's float32 train step on one CUDA card.

    python3 tools/profile_train_torch.py

Builds the full-width ``ISTNet`` of ``istnet_tpu_torch`` (default recipe,
B=24, N=1024, 192x192, random weights), takes 3 warmup steps, then
profiles 3 steps twice with ``torch.profiler``. Prints, for each profiled
run on its own:

1. device activity only (CUDA; the host runs nearly as fast as
   unprofiled): the host wall time of the profiled steps, the device span
   (first kernel start to last kernel end), the device busy time (the
   union of the kernels' intervals) and the device's busy share of the
   span;
2. CPU ops and device activity (the op tracing slows the host): the same
   line, then the device time a step of the aten ops and kernels with the
   most self device time.

Imports no JAX.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BATCH, STEPS, TOP = 24, 3, 40


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


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        make_optimizer,
        train_step,
    )
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_torch: needs a CUDA card")
    dev = torch.device("cuda", 0)
    cfg = TrainConfig()
    model = build_train_model(dev, seed=1)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = make_train_batch(BATCH, seed=30, device=dev)
    for step in range(3):
        train_step(model, opt, batch, step, gen, cfg)
    torch.cuda.synchronize()
    n = STEPS
    print(f"{torch.cuda.get_device_name(0)}; B={BATCH} f32 train step, "
          f"{n} profiled steps a run")
    step = 3
    for label, activities in (
            ("device only", [ProfilerActivity.CUDA]),
            ("CPU ops + device", [ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA])):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                train_step(model, opt, batch, step, gen, cfg)
                step += 1
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        if not kernels:
            print(f"[{label}] the profiler saw no device activity")
            continue
        busy_us, span_us = busy_and_span(
            (e.time_range.start, e.time_range.end) for e in kernels)
        print(f"[{label}] host wall {wall_ms / n:.3f} ms a step, device span "
              f"{span_us / 1e3 / n:.3f} ms, device busy "
              f"{busy_us / 1e3 / n:.3f} ms ({len(kernels) // n} device "
              f"events a step): busy share {busy_us / span_us:.1%} of the "
              f"span")
    rows = sorted(prof.key_averages(),
                  key=lambda r: -r.self_device_time_total)[:TOP]
    for r in rows:
        if r.self_device_time_total > 0:
            print(f"{r.self_device_time_total / 1e3 / n:9.3f} ms/step "
                  f"x{r.count // n:5d}  {r.key[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
