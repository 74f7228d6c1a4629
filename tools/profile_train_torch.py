#!/usr/bin/env python3
"""Profile the PyTorch port's train step on one CUDA card.

    python3 tools/profile_train_torch.py [--dtype bfloat16] [--frozen]
        [--points 2048]

Builds the full-width ``ISTNet`` of ``istnet_tpu_torch`` (B=24, N=1024 or
``--points``, 192x192, random weights; the default recipe or, with
``--frozen``, the frozen one) under the compute policy ``--dtype``
(float32 or bfloat16), takes STEPS = 3 warmup steps, then profiles 3 steps
twice with ``torch.profiler``. Prints, for each profiled run on its own:

1. device activity only (CUDA; the host runs nearly as fast as
   unprofiled): the host wall time of the profiled steps, the device span
   (first kernel start to last kernel end), the device busy time (the
   union of the kernels' intervals) and the device's busy share of the
   span;
2. CPU ops and device activity (the op tracing slows the host): the same
   line, then the device time a step of the aten ops and kernels with the
   most self device time, then the step's device time by module and kind
   (``attribute``).

By span: each kernel's device time goes to the operation that launched
it, and that operation to the innermost of the program's spans around it
(``utils/tracing.py``): ``bn`` for every BatchNorm, the model's stages
(``feats`` ... ``up_3``, ``sa1``-``sa4`` with their FPS and grouping,
``fp1``-``fp4``, ``forward.*``), the loss (``step.loss``), ``adam`` and
``bn_ema`` (phase "update"), the input pipeline (``step.prepare``), else
"other"; a backward operation takes the span of the forward operation
that recorded its autograd node (the profiler's sequence numbers), so a
BN's backward counts as ``bn``. The kind
comes from the aten operation: convolutions (cuDNN), GEMMs (cuBLAS),
casts (``aten::_to_copy`` / ``copy_``), reductions (sums, means,
variances, norms, maxima), else elementwise; a kernel that no aten
operation launched is one of the port's (its wrappers and autograd
Functions launch through ctypes) and counts under its own name. The
attribution lives in ``istnet_tpu_torch/utils/profiling.py``, shared with
``tools/profile_fwd_torch.py``. Kernels the profiler links to no CPU
event stay out: the attributed total is printed beside the busy time.

``--device cpu`` runs the same attribution on the CPU (B=2, 48x48, SA
npoints 32/16/8/8) with the CPU's self time in place of device time: a
rehearsal of the script, which tier-1 runs, not a device measurement.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BATCH, STEPS, TOP = 24, 3, 40
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--frozen", action="store_true")
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        make_optimizer,
        train_step,
    )
    from istnet_tpu_torch.utils.profiling import (
        attribute,
        busy_and_span,
        device_kernels,
        print_attribution,
    )
    on_cpu = args.device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise SystemExit("profile_train_torch: needs a CUDA card")
    dev = torch.device(args.device)
    sync = (lambda: None) if on_cpu else torch.cuda.synchronize
    cfg = TrainConfig.frozen() if args.frozen else TrainConfig()
    # the CPU rehearsal runs the train parity tests' small model, one step
    sa = (32, 16, 8, 8) if on_cpu else (512, 256, 128, 64)
    img, batch_size, n = (48, 2, 1) if on_cpu else (192, BATCH, STEPS)
    model = build_train_model(dev, seed=1, freeze_world_enhancer=args.frozen,
                              sa_npoints=sa,
                              dtype=precision.dtype_named(args.dtype))
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = make_train_batch(batch_size, args.points, img, seed=30,
                             device=dev)
    for step in range(n):
        train_step(model, opt, batch, step, gen, cfg)
    sync()
    recipe = "frozen" if args.frozen else "default"
    name = torch.cuda.get_device_name(0) if not on_cpu else "CPU rehearsal"
    print(f"{name}; B={batch_size} N={args.points} {args.dtype} {recipe} "
          f"train step, {n} profiled steps a run")
    step = n
    runs = (("CPU ops", [ProfilerActivity.CPU]),) if on_cpu else (
        ("device only", [ProfilerActivity.CUDA]),
        ("CPU ops + device", [ProfilerActivity.CPU, ProfilerActivity.CUDA]))
    for label, activities in runs:
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                train_step(model, opt, batch, step, gen, cfg)
                step += 1
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
        if on_cpu:
            print(f"[{label}] host wall {wall_ms / n:.3f} ms a step")
            print_attribution(attribute(prof.events(), use_cpu=True), n,
                              "CPU self time (rehearsal)")
            continue
        kernels = device_kernels(prof.events())
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
    if on_cpu:
        return 0
    rows = sorted(prof.key_averages(),
                  key=lambda r: -r.self_device_time_total)[:TOP]
    for r in rows:
        if r.self_device_time_total > 0:
            print(f"{r.self_device_time_total / 1e3 / n:9.3f} ms/step "
                  f"x{r.count // n:5d}  {r.key[:110]}")
    print_attribution(attribute(prof.events()), n, "device time")
    return 0


if __name__ == "__main__":
    sys.exit(main())
