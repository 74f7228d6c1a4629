#!/usr/bin/env python3
"""Device time of the 3-NN pair (kernel 3, the FP interpolation, and kernel
10, the backward's 3-NN) and of kernel 8 (the backward's ball query), stage
by stage on every path that runs them:

    python3 tools/three_nn_variants_torch.py [--sweep]

Needs one CUDA card and nvcc. Device microseconds a call, each call first
checked against its plain version, summed over one pass of the path, read
two ways: by torch.profiler (``chip_smoke.device_us``, by kernel; it loses
whole calls' events now and then and reads NaN there) and by CUDA events
around the replays of a CUDA graph of 10 calls (``graph_us``: no host time
between the launches, the graph's own gaps included):

- kernel 3 at the FP stages of the B=32 eval forward (float32 and bf16
  features), of the serving bucket of 8 (both) and of the B=24 train step
  (``chip_smoke.kernel_cases``, ``kernel_cases_bf16``,
  ``train_kernel_cases``);
- kernel 10 at the train step's FP stages: the distances alone, and the
  weights the FP backward needs (the wrapper's ``weights=True`` variant
  where it takes that argument, else its distances and
  ``three_interpolate_weights`` after them, as the FP backward formed them
  before it had one; indices equal and weights within 2 ulp of the plain
  ones),
  beside ``torch.cdist(u, k).topk(3, largest=False)``, a yardstick of
  another formula that the port never calls;
- kernel 8 at the SA stages of the eval forward, the serving bucket and
  the train step.

With ``--sweep`` the script instead builds kernels 3 and 10 again for each
entry of ``SWEEP`` (a copy of their sources with constants replaced) and
prints each variant's device us a pass of the eval, serving (f32, bf16) and
train paths, every call checked against the plain version first (the profiler
reads NaN after the first rebuild in a process, so compare the graph
readings).

The package and ``chip_smoke`` are imported the usual way, this checkout's
last: with ``PYTHONPATH`` set to the root of another copy of the repository
(say the previous commit, unpacked with ``git archive``) the script times
that copy's wrappers. The first output lines are the card's name and power
limit and the directory of the package timed; then a line a call, then the
sums over each path.
"""

from __future__ import annotations

import inspect
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> [(file, old text, new text), ...]: the constants of three_nn.cuh
# (kGroup lanes a point, kUnroll known points a step of the scan,
# kBlockThreads) and of fp_interpolate.cu (kInFlightMax points whose rows
# a warp gathers at once)
HDR = "three_nn.cuh"
SWEEP = {
    "as built": [],
    "g=1": [(HDR, "kGroup = 8;", "kGroup = 1;")],
    "g=2": [(HDR, "kGroup = 8;", "kGroup = 2;")],
    "g=4": [(HDR, "kGroup = 8;", "kGroup = 4;")],
    "g=16": [(HDR, "kGroup = 8;", "kGroup = 16;")],
    "g=32": [(HDR, "kGroup = 8;", "kGroup = 32;")],
    "unroll 8": [(HDR, "kUnroll = 4;", "kUnroll = 8;")],
    "unroll 2": [(HDR, "kUnroll = 4;", "kUnroll = 2;")],
    "blocks of 64": [(HDR, "kBlockThreads = 128;", "kBlockThreads = 64;")],
    "blocks of 256": [(HDR, "kBlockThreads = 128;", "kBlockThreads = 256;")],
    "blocks of 512": [(HDR, "kBlockThreads = 128;", "kBlockThreads = 512;")],
    "2 points in flight": [("fp_interpolate.cu", "kInFlightMax = 4;",
                            "kInFlightMax = 2;")],
}
SWEEP_SOURCES = ("common.cu", "fp_interpolate.cu", "three_nn.cu", HDR)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def paths(cs, device) -> dict:
    """path -> kernel -> [(args, launches a pass)]."""
    serve = cs.SERVE_BUCKET
    train = cs.train_kernel_cases(device)

    def grouping_queries(cases):
        return [(args[:4], 1) for args in cases]

    out = {}
    for label, batch in (("eval", 0), ("serve", serve)):
        f32 = cs.kernel_cases(device, batch)
        b16 = cs.kernel_cases_bf16(device, batch)
        out[f"{label} f32"] = {
            "fp_interpolate": [(a, 1) for a in f32["fp_interpolate"]],
            "ball_query": grouping_queries(f32["ball_query_group"])}
        out[f"{label} bf16"] = {
            "fp_interpolate": [(a, 1) for a, on in b16["fp_interpolate"]
                               if on]}
    out["train"] = {
        "fp_interpolate": [(a, k) for a, k in train["fp_interpolate"]],
        "three_nn": [(a[:2], k) for a, k in train["three_nn"]],
        "ball_query": [(a, k) for a, k in train["ball_query"]]}
    return out


def graph_us(fn, calls: int = 10, replays: int = 5) -> float:
    """Microseconds a call of ``fn`` replayed from a CUDA graph of
    ``calls`` calls, timed by CUDA events over ``replays`` replays."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) * 1e3 / (calls * replays)


def weights_call(kern, plain, unknown, known):
    """The FP backward's ``(weight, idx)`` a call: kernel 10's weights
    variant where the wrapper takes ``weights``, else its distances and the
    plain weights after them."""
    if "weights" in inspect.signature(kern).parameters:
        return lambda: kern(unknown, known, weights=True)

    def call():
        dist, idx = kern(unknown, known)
        return plain.three_interpolate_weights(dist), idx
    return call


def check_weights(cs, fn, plain, unknown, known) -> None:
    """``fn()``'s indices equal to the plain ones, its weights within 2 ulp
    of ``three_interpolate_weights`` of the plain distances."""
    import torch
    weight, idx = fn()
    dist, want_idx = plain.three_nn(unknown, known)
    want = plain.three_interpolate_weights(dist)
    ulp = torch.nextafter(want.abs(), torch.full_like(want, float("inf"))) \
        - want.abs()
    if not torch.equal(idx, want_idx) or \
            not ((weight - want).abs() <= 2 * ulp).all():
        raise AssertionError(f"three_nn "
                             f"{cs._label('three_nn', (unknown, known, True))}"
                             f" differ")


def check(cs, name: str, kern, mod, args) -> None:
    import torch
    got, want = kern(*args), mod.plain(*args)
    if name in ("three_nn", "ball_query"):
        for g, w in zip(got, want):
            if not torch.equal(g, w):
                raise AssertionError(f"{name} {cs._label(name, args)} differs")
        return
    bf16 = args[2].dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max().item()
    tol = cs.BF16_FP_TOL if bf16 else cs.FP_REL_TOL
    if got.dtype != want.dtype or err > tol * want.float().abs().max().item():
        raise AssertionError(f"{name} {cs._label(name, args)}: {err}")


def time_paths(cs, device, only=None) -> dict:
    """Device us a call of every case, printed; per (path, what) the sum
    over one pass of the path."""
    import torch

    from istnet_tpu_torch.ops import dispatch
    from istnet_tpu_torch.ops import pointnet2 as plain
    sums: dict = {}
    for path, kernels in paths(cs, device).items():
        if only and path not in only:
            continue
        for name, case_list in kernels.items():
            if only and name not in only[path]:
                continue
            kern = dispatch.wrapper(name)
            mod = dispatch.KERNELS[name]
            for args, launches in case_list:
                check(cs, name, kern, mod, args)
                reads = {name: lambda: kern(*args)}
                if name == "three_nn":
                    u, k = args
                    reads["three_nn + weights"] = weights_call(kern, plain,
                                                               u, k)
                    check_weights(cs, reads["three_nn + weights"], plain, u,
                                  k)
                    reads["cdist + topk (yardstick)"] = (
                        lambda: torch.cdist(u, k).topk(3, largest=False))
                parts = []
                for what, fn in reads.items():
                    by_kernel = cs.device_us(fn)
                    us = sum(by_kernel.values()) or float("nan")
                    g_us = graph_us(fn)
                    detail = ", ".join(f"{kn} {v:.1f}" for kn, v in
                                       sorted(by_kernel.items()))
                    parts.append(f"{what} {us:.1f} ({detail}), graph "
                                 f"{g_us:.1f}")
                    for how, v in (("profiler", us), ("graph", g_us)):
                        key = (path, what, how)
                        sums[key] = sums.get(key, 0.0) + v * launches
                dtype = str(args[2].dtype).removeprefix("torch.") \
                    if name == "fp_interpolate" else "float32"
                print(f"{path} {name} {cs._label(name, args)} {dtype} "
                      f"x{launches}: device us a call: " + "; ".join(parts))
    for (path, what, how), us in sums.items():
        print(f"pass sum {path} {what} ({how}): {us:.1f} us")
    return sums


SWEPT = {"eval f32": ("fp_interpolate",), "eval bf16": ("fp_interpolate",),
         "serve f32": ("fp_interpolate",), "serve bf16": ("fp_interpolate",),
         "train": ("fp_interpolate", "three_nn")}


def sweep(cs, device) -> None:
    """Each SWEEP variant built into the package's build directory, its
    kernels checked and timed on the SWEPT paths."""
    from _sweep_torch import edited_build

    from istnet_tpu_torch.ops import _build
    for name, edits in SWEEP.items():
        print(f"sweep {name!r}:")
        with edited_build(name, edits, SWEEP_SOURCES):
            try:
                sums = time_paths(cs, device, SWEPT)
            except (AssertionError, RuntimeError) as e:
                print(f"sweep {name!r} failed: {e}")
                continue
            seconds = _build.build_info.get("seconds", 0.0)
            regs = [line.strip() for line in
                    _build.build_info.get("log", "").splitlines()
                    if "registers" in line]
        print(f"sweep {name!r} (built in {seconds:.1f} s) pass sums: "
              + ", ".join(f"{p} {w} {v:.1f}" for (p, w, how), v in
                          sums.items()
                          if how == "graph" and "yardstick" not in w))
        for line in regs:
            print(f"  {line}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("three_nn_variants_torch: no CUDA card")
    sys.path.append(REPO)
    import chip_smoke as cs
    import istnet_tpu_torch
    print(smi())
    print(f"package {os.path.dirname(istnet_tpu_torch.__file__)}")
    device = torch.device("cuda", 0)
    with cs.policy(torch.float32):
        if "--sweep" in sys.argv[1:]:
            sweep(cs, device)
        else:
            time_paths(cs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
