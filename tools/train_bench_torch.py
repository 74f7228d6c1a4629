#!/usr/bin/env python3
"""Train-step benchmark of ``istnet_tpu_torch`` on one CUDA card, the
counterpart of ``tools/train_bench.py``.

    python3 tools/train_bench_torch.py [--host-pipeline] [--batch 24]
        [--f32] [--points 1024] [--freeze] [--rounds 5] [--iters 10]

Measures steps/s of the whole train step at the reference's production
setting (B = 18 syn + 6 real = 24, 1024 points, 192^2 crops, bf16 compute
unless ``--f32``): with the device pipeline (the default), the raw batch of
``entry.make_train_raw_batch`` goes through ``make_train_preprocess``
(depth completion on kernel 11, crop, in-mask sampling, back-projection,
jitter, ColorJitter, ``qo``) and ``make_device_augment`` (the FS-Net box
and rigid augmentation) inside ``train_state.train_step``, then forward,
loss, backward, Adam and the BN EMA; with ``--host-pipeline`` the step
takes an already prepared batch (``make_host_batch``) and only the
augmentation runs in front of the forward. The recipe is
``tools/train_bench.py``'s (``RECIPE``).

Timing: ``utils/profiling.rounds_ms``, rounds of ``iters`` eager steps back
to back under CUDA events, one synchronise a round, the collector off. The
JAX bench chains its steps in one ``fori_loop`` and perturbs the depth so
that XLA hoists nothing; eager steps need neither. Nothing in a round
waits for the device: the loss parts are read after the rounds.

Prints one JSON line with ``tools/train_bench.py``'s keys
(``train_steps_per_sec``, ``step_ms``, ``samples_per_sec``, ``batch``,
``pipeline``, ``points``, ``freeze_world_enhancer``, ``dtype``), with
``build_s`` (the kernel build and the first step) in place of
``compile_s``, the card's name in ``backend`` and the rounds' spread. Exits
non-zero without a card; ``device="cpu"`` (a rehearsal at small shapes
for the tests, no device time) is asked for by the caller, never taken as
a fallback. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROUNDS, ITERS = 5, 10
DATA_SEED, MODEL_SEED, STEP_SEED = 0, 0, 42
# tools/train_bench.py:123-131: the optimizer's lr is not read (the cyclic
# schedule sets it), as in the JAX package's make_optimizer
RECIPE = {"optimizer": {"name": "Adam", "lr": 0.01, "weight_decay": 0},
          "max_epoch": 30,
          "bn": {"bn_momentum": 0.9, "bn_decay": 0.5, "decay_step": 4000,
                 "bnm_clip": 0.01}}
ITERS_PER_EPOCH = 4000
GAMMA1, GAMMA2, GAMMA2_FROZEN = 1.0, 10.0, 100.0


def make_host_batch(b: int, n: int = 1024, img: int = 192, seed: int = 0,
                    device="cuda") -> dict:
    """``tools/train_bench.py::make_host_batch``: a prepared train batch
    (``{"inputs", "labels"}``) from a numpy ``RandomState(seed)`` with the
    same draws, on ``device``."""
    import torch

    from istnet_tpu_torch.entry import on_device
    device = on_device(device, "make_host_batch")
    rng = np.random.RandomState(seed)
    inputs = {
        "rgb": rng.rand(b, img, img, 3).astype(np.float32),
        "pts": (rng.randn(b, n, 3) * 0.1).astype(np.float32),
        "choose": rng.randint(0, img * img, size=(b, n)).astype(np.int32),
        "category_label": rng.randint(0, 6, size=(b,)).astype(np.int32),
        "qo": (rng.randn(b, n, 3) * 0.1).astype(np.float32),
        "sym_info": np.zeros((b, 4), np.int32),
    }
    labels = {
        "rotation_label": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
        "translation_label": np.zeros((b, 3), np.float32),
        "size_label": np.ones((b, 3), np.float32),
        "qo": inputs["qo"],
    }
    return {part: {k: torch.from_numpy(v).to(device) for k, v in d.items()}
            for part, d in (("inputs", inputs), ("labels", labels))}


def recipe(freeze: bool):
    """The bench's ``TrainConfig``: ``RECIPE`` with the loss weights of
    ``tools/train_bench.py:131`` (gamma2 100 when frozen)."""
    from istnet_tpu_torch.train.train_state import TrainConfig
    from istnet_tpu_torch.utils.config import Config

    cfg = Config({**RECIPE, "num_mini_batch_per_epoch": ITERS_PER_EPOCH,
                  "freeze_world_enhancer": freeze,
                  "loss": {"gamma1": GAMMA1,
                           "gamma2": GAMMA2_FROZEN if freeze else GAMMA2}})
    return TrainConfig.from_config(cfg)


def build_step(batch: int = 24, host_pipeline: bool = False,
               f32: bool = False, points: int = 1024, freeze: bool = False,
               device="cuda", img: int = 192, sa_npoints=None):
    """The bench's step, ready to run: ``step()`` takes one train step
    (its step count advancing) and returns its detached loss parts. Sets
    the compute policy (bf16 unless ``f32``); the caller restores it."""
    import torch

    from istnet_tpu_torch.data.device_augment import make_device_augment
    from istnet_tpu_torch.data.device_preprocess import make_train_preprocess
    from istnet_tpu_torch.entry import (SA_NPOINTS, build_train_model,
                                        make_train_raw_batch, on_device)
    from istnet_tpu_torch.train.train_state import make_optimizer, train_step

    device = on_device(device, "measure_train_steps")
    cfg = recipe(freeze)
    model = build_train_model(
        device, MODEL_SEED, freeze_world_enhancer=freeze,
        sa_npoints=sa_npoints or SA_NPOINTS,
        dtype=torch.float32 if f32 else torch.bfloat16)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(STEP_SEED)
    if host_pipeline:
        data = make_host_batch(batch, points, img, DATA_SEED, device)
        pre = None
    else:
        data = make_train_raw_batch(batch, DATA_SEED, device)
        pre = make_train_preprocess(img_size=img, sample_num=points)
    augment = make_device_augment()
    count = [0]

    def step() -> dict:
        parts = train_step(model, opt, data, count[0], gen, cfg, pre,
                           augment)
        count[0] += 1
        return parts

    return step


def measure_train_steps(batch: int = 24, host_pipeline: bool = False,
                        f32: bool = False, points: int = 1024,
                        freeze: bool = False, device="cuda", *,
                        rounds: int = ROUNDS, iters: int = ITERS,
                        img: int = 192, sa_npoints=None) -> dict:
    """Steps/s of the bench's step (``build_step``) on ``device``: the
    first step (with the kernel build) timed on its own as ``build_s``,
    then ``rounds`` rounds of ``iters`` steps (``profiling.rounds_ms``,
    one warmup step). Returns ``tools/train_bench.py``'s keys, the
    rounds' ms and spread, the first step's loss parts and the last
    one's total, every loss finite or it raises. The compute policy is
    restored after."""
    import torch

    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.ops import _build
    from istnet_tpu_torch.utils.profiling import rounds_ms

    on_card = torch.device(device).type == "cuda"
    old = precision.compute_dtype()
    try:
        t0 = time.perf_counter()
        if on_card:
            _build.library()
        step = build_step(batch, host_pipeline, f32, points, freeze,
                                device, img, sa_npoints)
        first = step()
        if on_card:
            torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        parts = []
        timing = rounds_ms(lambda: parts.append(step()), rounds, iters,
                           device=device)
    finally:
        precision.set_compute_dtype(old)
    first = {k: float(v) for k, v in first.items()}
    totals = [float(p["total"]) for p in parts]
    if not all(map(math.isfinite, totals + list(first.values()))):
        raise FloatingPointError(f"measure_train_steps: a loss is not "
                                 f"finite: first step {first}, then {totals}")
    ms = timing["median"]
    return {
        "train_steps_per_sec": 1e3 / ms,
        "step_ms": ms,
        "samples_per_sec": batch * 1e3 / ms,
        "batch": batch,
        "pipeline": "host" if host_pipeline else "device",
        "points": points,
        "freeze_world_enhancer": freeze,
        "dtype": "float32" if f32 else "bfloat16",
        "build_s": build_s,
        "backend": torch.cuda.get_device_name(0) if on_card else "cpu",
        "step_ms_rounds": timing["rounds"],
        "step_ms_min": timing["min"],
        "step_ms_max": timing["max"],
        "rounds": rounds,
        "iters": iters,
        "first_loss_parts": first,
        "last_loss": totals[-1],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=24)
    p.add_argument("--host-pipeline", action="store_true",
                   help="the step WITHOUT device preprocessing (a prepared "
                        "batch), for the breakdown")
    p.add_argument("--f32", action="store_true")
    p.add_argument("--points", type=int, default=1024)
    p.add_argument("--freeze", action="store_true",
                   help="freeze_world_enhancer two-phase recipe")
    p.add_argument("--rounds", type=int, default=ROUNDS)
    p.add_argument("--iters", type=int, default=ITERS)
    args = p.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_bench_torch: needs a CUDA card")
    print(json.dumps(measure_train_steps(
        args.batch, args.host_pipeline, args.f32, args.points, args.freeze,
        rounds=args.rounds, iters=args.iters)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
