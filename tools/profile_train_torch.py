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

By module: each kernel's device time goes to the operation that launched
it, and that operation to its owner: the innermost BatchNorm, Dropout2d or
PReLU whose forward ran it, the loss (``supervised_loss``), Adam, or the
BN EMA (``update_bn_stats``), else "other"; a backward operation takes the
owner of the forward operation that recorded its autograd node (the
profiler's sequence numbers), so a BN's backward counts as BN. The kind
comes from the aten operation: convolutions (cuDNN), GEMMs (cuBLAS),
casts (``aten::_to_copy`` / ``copy_``), reductions (sums, means,
variances, norms, maxima), else elementwise; a kernel that no aten
operation launched is one of the port's (its wrappers and autograd
Functions launch through ctypes). Kernels the profiler links to no CPU
event stay out: the attributed total is printed beside the busy time.

``--device cpu`` runs the same attribution on the CPU (B=2, 48x48, SA
npoints 32/16/8/8) with the CPU's self time in place of device time: a
rehearsal of the script, which tier-1 runs, not a device measurement.
Imports no JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BATCH, STEPS, TOP = 24, 3, 40
OWNERS = ("BatchNorm", "Dropout2d", "PReLU")
TAG = "owner:"
REDUCTIONS = ("sum", "mean", "var", "norm", "max", "amax", "min", "std")


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


@contextlib.contextmanager
def owner_ranges(model, train_state):
    """``record_function`` ranges naming the owners: the forward of every
    BatchNorm, Dropout2d and PReLU, the loss, Adam (the profiler names its
    step) and the BN EMA."""
    import torch
    from torch.profiler import record_function

    open_ranges = {}
    hooks = []

    def enter(module, _):
        rf = record_function(TAG + type(module).__name__)
        rf.__enter__()
        open_ranges.setdefault(id(module), []).append(rf)

    def leave(module, _, __):
        open_ranges[id(module)].pop().__exit__(None, None, None)

    for m in model.modules():
        if type(m).__name__ in OWNERS:
            hooks.append(m.register_forward_pre_hook(enter))
            hooks.append(m.register_forward_hook(leave))

    def wrap(fn, name):
        def wrapped(*a, **k):
            with record_function(TAG + name):
                return fn(*a, **k)
        return wrapped
    saved = {k: getattr(train_state, k)
             for k in ("supervised_loss", "update_bn_stats")}
    train_state.supervised_loss = wrap(saved["supervised_loss"], "loss")
    train_state.update_bn_stats = torch.no_grad()(
        wrap(saved["update_bn_stats"], "BN EMA"))
    try:
        yield
    finally:
        for h in hooks:
            h.remove()
        for k, v in saved.items():
            setattr(train_state, k, v)


def _owner(evt) -> str | None:
    while evt is not None:
        if evt.name.startswith(TAG):
            return evt.name[len(TAG):]
        if evt.name.startswith("Optimizer.step#"):
            return "Adam"
        evt = evt.cpu_parent
    return None


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


def attribute(events, use_cpu: bool = False) -> dict:
    """{(phase, owner, kind): us} over ``events`` (a profile of CPU ops
    and device activity): the device time of each kernel (with
    ``use_cpu``, each CPU op's self time) under the operation that
    launched it."""
    import torch
    cpu = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU]
    fwd_owner = {}
    for e in cpu:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            fwd_owner.setdefault(e.sequence_nr, _owner(e))
    out = collections.Counter()
    for e in cpu:
        if use_cpu:
            if not e.name.startswith("aten::") or e.cpu_children:
                continue
            us = e.self_cpu_time_total
        else:
            us = sum(k.duration for k in e.kernels)
        if not us:
            continue
        kind = _kind(e.name) if e.name.startswith("aten::") else \
            "port kernels"
        phase, owner, node = "forward", None, e
        while node is not None:
            if node.name.startswith("autograd::engine::evaluate_function"):
                phase = "backward"
                owner = fwd_owner.get(node.sequence_nr)
                break
            node = node.cpu_parent
        if phase == "forward":
            owner = _owner(e)
            if owner in ("Adam", "BN EMA"):
                phase = "update"
        out[(phase, owner or "other", kind)] += us
    return out


def print_attribution(table: dict, steps: int, unit: str) -> None:
    """Per phase, per owner: ms a step by kind, largest first."""
    total = sum(table.values())
    print(f"[by module] {unit} a step: {total / 1e3 / steps:.3f} ms "
          f"attributed")
    rows = collections.defaultdict(collections.Counter)
    for (phase, owner, kind), us in table.items():
        rows[(phase, owner)][kind] += us
    for (phase, owner), kinds in sorted(rows.items(),
                                        key=lambda kv: -sum(kv[1].values())):
        s = sum(kinds.values())
        parts = ", ".join(f"{k} {v / 1e3 / steps:.3f}"
                          for k, v in kinds.most_common())
        print(f"[by module] {phase:8s} {owner:10s} {s / 1e3 / steps:8.3f} "
              f"ms ({parts})")
    kinds = collections.Counter()
    for (_, _, kind), us in table.items():
        kinds[kind] += us
    print("[by module] by kind: " + ", ".join(
        f"{k} {v / 1e3 / steps:.3f} ms" for k, v in kinds.most_common()))


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
    from istnet_tpu_torch.train import train_state
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        make_optimizer,
        train_step,
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
        with owner_ranges(model, train_state), \
                profile(activities=activities) as prof:
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
