#!/usr/bin/env python3
"""The end-to-end paths of ``istnet_tpu_torch`` timed several times over in
one process: the B=32 eval forward and the serving frame (a raw frame of 6
instances in a bucket of 8) under both compute policies, then the float32
train step at B=24.

    python3 tools/time_paths_torch.py [--rounds 3] [--iters 10] [--no-train]

Needs one CUDA card and nvcc. ``chip_smoke.py`` times each path once a run;
these paths are host-bound and spread from run to run, so one reading cannot
tell a change of the code from a change of the host. This script repeats
each reading ``--rounds`` times, ``--iters`` calls each: the mean by CUDA
events, the mean on the host clock around a synchronise, and the slowest
single call by events (a stall of the host shows there and not in the
others). The kernels of the fused SA stage and of the fold are timed stage
by stage in ``chip_smoke.py`` itself (``device us a call by stage``).

The package and ``chip_smoke`` are imported the usual way, this checkout's
last: with ``PYTHONPATH`` set to the root of another copy of the repository
that has the same entry points (say the previous commit, unpacked with
``git archive``) the script times that copy, so that two commits can be run
in turn on one card in one go. The first output lines are the card's
name and power limit and the directory of the package that was timed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(fn, rounds: int, iters: int) -> str:
    """``rounds`` readings of ``iters`` calls of ``fn``, as text."""
    import torch
    out = []
    for _ in range(rounds):
        fn()
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        marks[0].record()
        for mark in marks[1:]:
            fn()
            mark.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
        each = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        out.append(f"{sum(each) / iters:.3f} events, {wall:.3f} host clock, "
                   f"slowest call {max(each):.3f}")
    return "; ".join(out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-train", action="store_true",
                    help="leave out the train step")
    args = ap.parse_args()
    sys.path.append(REPO)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("time_paths_torch: no CUDA card")
    import chip_smoke
    import istnet_tpu_torch
    from istnet_tpu_torch.entry import (
        build_device_forward,
        build_serving_model,
        make_inputs,
    )
    from istnet_tpu_torch.nn import precision

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(f"package {os.path.dirname(istnet_tpu_torch.__file__)}")
    dev = torch.device("cuda", 0)
    inp = make_inputs(chip_smoke.BATCH, seed=1, device=dev)
    frame = chip_smoke._serve_frame(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for tag, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        model = build_serving_model(dtype, dev)
        with torch.inference_mode():
            print(f"[paths] B={chip_smoke.BATCH} eval forward {tag}, ms a "
                  f"call: {readings(lambda: model(inp), args.rounds, args.iters)}")
        _, fn = build_device_forward(dtype, dev)
        with torch.inference_mode():
            print(f"[paths] serving frame {tag}, ms a frame: "
                  f"{readings(lambda: fn(*frame, gen), args.rounds, args.iters)}")
        precision.set_compute_dtype(torch.float32)
    if not args.no_train:
        chip_smoke.phase_train_timings(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
