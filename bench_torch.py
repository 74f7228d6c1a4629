#!/usr/bin/env python3
"""Benchmark of ``istnet_tpu_torch`` on one CUDA card: object pose
inferences/sec/chip, the counterpart of ``bench.py``.

    python3 bench_torch.py [--rounds 5] [--iters 20]

Measures the full-width ISTNet eval forward (the graph ``cli/test.py`` runs
per instance batch, the sparse point-decode head included) at production
shapes (1024 points, 192x192 crops) under the bf16 deployment policy
(``entry.build_serving_model``, inputs from ``entry.make_inputs``,
``torch.inference_mode``) at batch 32 (BASELINE config #2's batched
inference) and 128 (the peak-throughput serving batch), and prints ONE JSON
line with ``bench.py``'s keys: ``value`` is the larger of the two rates,
``batch`` the batch that gave it, ``b32_value`` / ``b128_value`` both, and
``train_steps_per_sec`` / ``train_samples_per_sec`` / ``train_batch`` the
bf16 default-recipe train step at B=24 with the device pipeline inside it
(``tools/train_bench_torch.py::measure_train_steps``, the step of
``bench.py``'s secondary metric).

Extra keys on the same line: the float32 forward at both batches; each
configuration's ms a call by round, median and min-max, its rate's min-max
and its peak device memory (reset between configurations); the device's
busy share over one separate profiled round of each configuration (device
activity only, ``utils/profiling.busy_and_span``; the timed rounds run
without the profiler); the bare steps (a prepared batch, no device
preprocessing) of the default and frozen recipes under float32 and bf16;
the card's name and power limit as ``nvidia-smi`` gives them.

Timing: ``utils/profiling.rounds_ms``, ``--rounds`` rounds (at least 5 by
default) of ``--iters`` back-to-back calls under CUDA events with one
synchronise a round, the collector off, after warmup; ``value`` and the
other rates come from the median round. No number depends on
``profiling.device_us``.

Baseline: the reference (CVMI-Lab/IST-Net) publishes no throughput.
``REF_ESTIMATE`` is ``bench.py``'s FLOP-audited estimate of the reference
as shipped on an RTX-3090-class card (250 inferences/s, 150-400;
``BASELINE.md:70-71``), not a TPU number; ``vs_baseline`` is value /
REF_ESTIMATE.

Without a card it exits non-zero and prints no JSON line; a failed part
ends the run with its traceback and a non-zero exit. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "tools"))

# the reference as shipped, estimated (BASELINE.md:70-71; bench.py:41)
REF_ESTIMATE = 250.0
METRIC = "object pose inferences/sec/chip"
BATCHES = (32, 128)
ROUNDS, ITERS, WARMUP = 5, 20, 3
TRAIN_BATCH = 24
# the bare steps: (key, float32, frozen recipe)
BARE_STEPS = (("f32_default", True, False), ("f32_frozen", True, True),
              ("bf16_default", False, False), ("bf16_frozen", False, True))
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def card_name_and_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def forward_case(dtype: torch.dtype, batch: int, device="cuda",
                 seed: int = 0, model=None):
    """``(fn, model, inputs)``: one bench forward, ``fn()`` the eval forward
    of ``model`` (``entry.build_serving_model(dtype)`` from ``seed`` unless
    given) on ``entry.make_inputs(batch, seed=seed)`` under
    ``torch.inference_mode``. Sets the compute policy ``dtype``."""
    from istnet_tpu_torch.entry import build_serving_model, make_inputs
    from istnet_tpu_torch.nn import precision

    if model is None:
        model = build_serving_model(dtype, device, seed)
    precision.set_compute_dtype(dtype)
    inputs = make_inputs(batch, seed=seed, device=device)

    def fn():
        with torch.inference_mode():
            return model(inputs)

    return fn, model, inputs


def busy_share(fn, iters: int) -> float:
    """The device's busy share of its span over one round of ``iters``
    calls of ``fn`` under torch.profiler (device activity only); NaN where
    the profiler saw no device event."""
    from torch.profiler import ProfilerActivity, profile

    from istnet_tpu_torch.utils.profiling import busy_and_span, device_kernels
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end)
             for e in device_kernels(prof.events())]
    if not spans:
        return float("nan")
    busy, span = busy_and_span(spans)
    return busy / span


def measure_forward(dtype: torch.dtype, batches=BATCHES, rounds: int = ROUNDS,
                    iters: int = ITERS, device="cuda") -> dict:
    """Per batch of ``batches``, the bench forward under ``dtype``:
    ``{batch: {"inf_per_s", "inf_per_s_min", "inf_per_s_max", "ms",
    "ms_rounds", "ms_min", "ms_max", "peak_gib", "busy_share"}}``, one
    model for all batches. The compute policy is restored after."""
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.utils.profiling import rounds_ms

    old = precision.compute_dtype()
    out = {}
    model = None
    try:
        for b in batches:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            fn, model, _ = forward_case(dtype, b, device, model=model)
            t = rounds_ms(fn, rounds, iters, warmup=WARMUP)
            peak = torch.cuda.max_memory_allocated() / 2**30
            out[b] = {"inf_per_s": b * 1e3 / t["median"],
                      "inf_per_s_min": b * 1e3 / t["max"],
                      "inf_per_s_max": b * 1e3 / t["min"],
                      "ms": t["median"], "ms_rounds": t["rounds"],
                      "ms_min": t["min"], "ms_max": t["max"],
                      "peak_gib": peak, "busy_share": busy_share(fn, iters)}
    finally:
        precision.set_compute_dtype(old)
    return out


def measure(rounds: int = ROUNDS, iters: int = ITERS,
            train_rounds: int | None = None, train_iters: int | None = None,
            device="cuda") -> dict:
    """Every measurement of the bench: ``{"forward": {"bf16" | "f32":
    measure_forward(...)}, "train": measure_train_steps of the bench's
    step, "bare": {key: measure_train_steps(host_pipeline=True, ...)}}``.
    The train parts take ``train_rounds`` / ``train_iters`` (the train
    bench's defaults when None)."""
    from train_bench_torch import ITERS as T_ITERS
    from train_bench_torch import ROUNDS as T_ROUNDS
    from train_bench_torch import measure_train_steps

    kw = {"rounds": train_rounds or T_ROUNDS, "iters": train_iters or T_ITERS}
    forward = {name: measure_forward(dtype, BATCHES, rounds, iters, device)
               for name, dtype in DTYPES.items()}
    train = measure_train_steps(TRAIN_BATCH, device=device, **kw)
    bare = {key: measure_train_steps(TRAIN_BATCH, host_pipeline=True, f32=f32,
                                     freeze=frozen, device=device, **kw)
            for key, f32, frozen in BARE_STEPS}
    return {"forward": forward, "train": train, "bare": bare}


def make_record(m: dict, card: str) -> dict:
    """The JSON line: ``bench.py``'s keys from the measurements ``m``
    (``measure``'s), then the extra keys; ``card`` is nvidia-smi's name
    and power limit."""
    bf16 = m["forward"]["bf16"]
    b32, b128 = bf16[32]["inf_per_s"], bf16[128]["inf_per_s"]
    value = max(b32, b128)
    tr = m["train"]
    record = {
        "metric": METRIC,
        "value": value,
        "unit": "inferences/sec",
        "vs_baseline": value / REF_ESTIMATE,
        "batch": 128 if b128 >= b32 else 32,
        "b32_value": b32,
        "b128_value": b128,
        "train_steps_per_sec": tr["train_steps_per_sec"],
        "train_samples_per_sec": tr["samples_per_sec"],
        "train_batch": tr["batch"],
    }
    name, _, limit = card.partition(",")
    record["device"] = {"name": name.strip(), "power_limit": limit.strip()}
    for policy, by_batch in m["forward"].items():
        for b, r in by_batch.items():
            record[f"forward_{policy}_b{b}"] = r
    record["f32_b32_value"] = m["forward"]["f32"][32]["inf_per_s"]
    record["f32_b128_value"] = m["forward"]["f32"][128]["inf_per_s"]
    record["train"] = tr
    record["train_bare"] = m["bare"]
    return record


def rates(record: dict) -> list[float]:
    """Every rate of a record: the forwards' inferences/s (median, min,
    max) and the steps' steps/s."""
    out = [record["value"], record["b32_value"], record["b128_value"],
           record["train_steps_per_sec"], record["train_samples_per_sec"]]
    for k, v in record.items():
        if k.startswith("forward_"):
            out += [v["inf_per_s"], v["inf_per_s_min"], v["inf_per_s_max"]]
    out += [s["train_steps_per_sec"] for s in record["train_bare"].values()]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch: torch.cuda.is_available() is false; "
                         "the bench needs a CUDA card")
    card = card_name_and_limit()
    from istnet_tpu_torch.ops import _build
    _build.library()
    record = make_record(measure(args.rounds, args.iters), card)
    bad = [r for r in rates(record) if not (math.isfinite(r) and r > 0)]
    if bad:
        raise AssertionError(f"bench_torch: rates not finite and positive: "
                             f"{bad}")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
