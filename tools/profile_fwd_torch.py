#!/usr/bin/env python3
"""Device time of the ``istnet_tpu_torch`` eval forward by module on one
CUDA card, the counterpart of ``tools/profile_fwd.py``.

    python3 tools/profile_fwd_torch.py [--target fwd|train] [--batch 128]
        [--dtype bfloat16|float32] [--top 40]

Target ``fwd``: the full-width eval forward (``entry.build_serving_model``
under ``--dtype``, ``entry.make_inputs(--batch)``, N=1024, 192x192,
``torch.inference_mode``), CALLS warm calls, then CALLS calls profiled
twice:

1. device activity only: host wall ms a forward, the device span, the
   device busy time (the union of the kernels' intervals) and the busy
   share of the span;
2. a trace of CPU ops and device activity (``utils/profiling.trace``,
   ``parse_trace``): the kernels with the most device time, then each
   forward's device time by the program's span and kind
   (``utils/profiling.attribute_rows``: a row goes to the innermost span
   open around its launch on the host, so the port's kernels, launched
   through ctypes outside any aten op, count too). The spans
   (``utils/tracing.py``): the RGB encoder's ``feats``, ``psp``, ``up_1``,
   ``up_2`` (the fold, kernel 4, at bf16 and f32 eval) and ``up_3`` (with
   the final head and the sparse point decode), PointNet2MSG's
   ``sa1``-``sa4`` and ``fp1``-``fp4`` (FPS, grouping and 3-NN inside
   their stage), ``forward.transform``, ``forward.estimate``, every
   BatchNorm's ``bn``, and what the forward runs outside them as
   ``forward`` / ``forward.rgb`` / ``forward.points``; time outside every
   span is "other". The kinds: convolutions, GEMMs, casts (copies
   included: the fold's copy of ``up_2``'s non-contiguous input is a
   "casts" row of ``up_2``), reductions, elementwise, and each of the
   port's kernels by name. The total of the trace's device rows is
   printed beside the attributed sum.

Target ``train``: ``tools/profile_train_torch.py``'s attribution of the
B=24 train step (``--dtype``, ``--frozen``, ``--points``).

``--device cpu`` rehearses ``fwd`` on the CPU (B=2, 48x48, SA npoints
32/16/8/8) with CPU self time in place of device time; tier-1 runs it.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

CALLS, TOP = 3, 40


def profile_forward(batch: int, dtype: str, device: str, top: int = TOP
                    ) -> dict:
    """Profile the eval forward (target ``fwd``); prints the lines above
    and returns ``{"total_ms", "attributed_ms", "table"}`` a forward: on the
    card the device time of the trace's rows (``attribute_rows``), on the
    CPU the self CPU time of the aten ops (``attribute``)."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from istnet_tpu_torch.entry import build_serving_model, make_inputs
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.utils import profiling

    on_cpu = device == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise SystemExit("profile_fwd_torch: needs a CUDA card")
    sa = (32, 16, 8, 8) if on_cpu else None
    img = 48 if on_cpu else 192
    old = precision.compute_dtype()

    def run():
        for _ in range(CALLS):
            model(inputs)
        if not on_cpu:
            torch.cuda.synchronize()

    try:
        model = build_serving_model(precision.dtype_named(dtype), device,
                                    **({"sa_npoints": sa} if sa else {}))
        inputs = make_inputs(batch, img=img, device=device)
        with torch.inference_mode():
            run()
            name = "CPU rehearsal" if on_cpu else torch.cuda.get_device_name(0)
            print(f"{name}; B={batch} N=1024 {img}x{img} {dtype} eval "
                  f"forward, {CALLS} profiled forwards a run")
            if on_cpu:
                with profile(activities=[ProfilerActivity.CPU]) as prof:
                    t0 = time.perf_counter()
                    run()
                    wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
                print(f"[CPU ops] host wall {wall_ms:.3f} ms a forward")
                table = profiling.attribute(prof.events(), use_cpu=True)
                total_us = sum(r.self_cpu_time_total
                               for r in prof.key_averages()
                               if r.key.startswith("aten::"))
                unit = "CPU self time (rehearsal)"
            else:
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run()
                    wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
                kernels = profiling.device_kernels(prof.events())
                busy_us, span_us = profiling.busy_and_span(
                    (e.time_range.start, e.time_range.end) for e in kernels)
                print(f"[device only] host wall {wall_ms:.3f} ms a forward, "
                      f"device span {span_us / 1e3 / CALLS:.3f} ms, device "
                      f"busy {busy_us / 1e3 / CALLS:.3f} ms "
                      f"({len(kernels) // CALLS} device events a forward): "
                      f"busy share {busy_us / span_us:.1%} of the span")
                with tempfile.TemporaryDirectory() as d:
                    with profiling.trace(d):
                        run()
                    rows = profiling.parse_trace(d)
                for a in profiling.aggregate_ops(rows, key="name", top=top,
                                                 calls=CALLS):
                    print(f"{a['dur_us'] / 1e3:9.3f} ms/fwd x{a['n']:5d}  "
                          f"{a['key'][:110]}")
                table = profiling.attribute_rows(rows)
                total_us = sum(r["dur_us"] for r in rows)
                unit = "device time"
    finally:
        precision.set_compute_dtype(old)
    attributed = profiling.print_attribution(table, CALLS, unit,
                                             per="forward")
    total = total_us / 1e3 / CALLS
    print(f"[by module] {unit}, every event: {total:.3f} ms a forward; "
          f"attributed {attributed:.3f} ms ({attributed / total:.1%})"
          if total else "[by module] no events")
    return {"total_ms": total, "attributed_ms": attributed, "table": table}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--target", default="fwd", choices=("fwd", "train"))
    p.add_argument("--batch", type=int, default=None,
                   help="128 on the card (profile_fwd.py's), 2 on the CPU")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("float32", "bfloat16"))
    p.add_argument("--points", type=int, default=1024,
                   help="points per instance (train target)")
    p.add_argument("--frozen", action="store_true",
                   help="the frozen recipe (train target)")
    p.add_argument("--top", type=int, default=TOP)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.target == "train":
        import profile_train_torch
        return profile_train_torch.main(
            ["--dtype", args.dtype, "--points", str(args.points),
             "--device", args.device] + (["--frozen"] if args.frozen else []))
    batch = args.batch or (2 if args.device == "cpu" else 128)
    profile_forward(batch, args.dtype, args.device, args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
