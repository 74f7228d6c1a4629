#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``istnet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each printing its own lines; any failure exits nonzero:

1. device: the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions;
2. build: compile the CUDA kernels from ``istnet_tpu_torch/csrc``;

then for each compute policy, float32 and bf16 (the deployment precision):

3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the main path gives it (bf16: the fused SA kernel at SA
   stages 2-4 and at stage 1's shape, and the bf16 variants of grouping,
   FP interpolation and fold);
4. forward: the full-width ISTNet eval forward (B=32, N=1024, 192x192)
   serving 3 batches, with the launch counts of every kernel;
5. reference: the same model and inputs at B=2, on the card against the
   port's plain-PyTorch CPU forward under the same policy (bf16: also the
   drift of the bf16 forward from the float32 one on the card);
6. timings: the B=32 forward and its sections, each kernel against its
   plain version (CUDA events after warmup); under bf16 also the fused SA
   kernel at stage 1 against the unfused stage 1;

then the float32 train step (``train/train_state.py``):

7. train kernels: every kernel the train step launches (the forward's FPS,
   grouping and FP interpolation; the backward's 8: multi-radius ball
   query, the grouping scatter, 10: 3-NN, the interpolation scatter)
   against its plain version at B=24 on the step's inputs: a train batch's
   points through the camera extractor's stages and its NOCS points
   through the world extractor's, every SA and FP stage with its radii;
8. train steps: the full-width model at B=24, N=1024, 192x192 takes 3 steps
   of the default recipe and 2 of the frozen one; each step's loss and
   gradients are finite, the trained parameters move, every BatchNorm's
   running statistics take the scheduled EMA, and every kernel launches as
   often as the step's path asks;
9. train reference: one step on the card against the same step of the
   port's CPU path (same weights and batch, dropout off, B=2, small
   npoints): the loss, the gradients and the updated state;
10. train timings: median step ms over 10 steps with its forward, backward
   and update split (CUDA events), peak memory, and each kernel's ms per
   step against its plain version's, from phase 7's cases.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import importlib.metadata
import json
import subprocess
import sys
import time

# (N, npoint) of the 4 SA stages
FPS_SHAPES = ((1024, 512), (512, 256), (256, 128), (128, 64))
# (N, M, feature channels) of the 4 SA stages; the output has 3 + C channels
BQG_SHAPES = ((1024, 512, 0), (512, 256, 64), (256, 128, 128), (128, 64, 256))
# (N unknown, M known, C) of the 4 FP stages, in call order
FP_SHAPES = ((128, 64, 512), (256, 128, 512), (512, 256, 256),
             (1024, 512, 256))
# up_2: (h, w, cin, cout)
FOLD_SHAPE = (48, 48, 256, 64)
NSAMPLES = (16, 32)
BATCH = 32
SERVED_BATCHES = 3
FP_REL_TOL = 1e-5       # normwise: max|kernel - plain| / max|plain|
FOLD_TOL = 1e-4         # max|kernel - plain| / max(1, max|plain|)
CPU_ATOL = 2e-4         # card vs CPU forward, absolute, every output
# bf16: (N, M, feature channels, MLP) of the fused SA stages 2-4, then the
# stage-1 shape (no features; the model keeps stage 1 unfused)
SA_FUSED_SHAPES = ((512, 256, 64, (32, 32, 64)), (256, 128, 128, (64, 64, 128)),
                   (128, 64, 256, (128, 128, 256)))
SA1_SHAPE = (1024, 512, 0, (16, 16, 32))
BF16_FP_TOL = 2.0 ** -8  # normwise, as FP_REL_TOL
BF16_FOLD_TOL = 1e-2    # as FOLD_TOL
SA_TOL = 2e-2           # max|kernel - plain| / max(1, max|plain|)
BF16_CPU_ATOL = 5e-3    # bf16 card vs bf16 CPU forward (measured <= 8.7e-4)
F32_PER_FORWARD = {"fps": 4, "ball_query_group": 4, "fp_interpolate": 4,
                   "fold_upsample": 1, "sa_fused": 0}
BF16_PER_FORWARD = {"fps": 4, "ball_query_group": 1, "fp_interpolate": 4,
                    "fold_upsample": 1, "sa_fused": 3}

# the float32 train step at the training width (config/ist_net_default.yaml)
TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG = 24, 1024, 192
TRAIN_SA_NPOINTS = (512, 256, 128, 64)
TRAIN_STEPS, FROZEN_STEPS, TIMED_STEPS = 3, 2, 10
SCATTER_TOL = 1e-5      # normwise, as FP_REL_TOL (f32 atomics: sum order)
# launches of one step: forward FPS / grouping / FP in both extractors
# (fold and fused SA are eval-only); backward kernel 8 + grouping scatter
# at SA 2-4 and kernel 10 + interpolation scatter at FP 1-4, of both
# extractors, or of the camera extractor alone in the frozen recipe
TRAIN_PER_STEP = {"fps": 8, "ball_query_group": 8, "fp_interpolate": 8,
                  "fold_upsample": 0, "sa_fused": 0, "ball_query": 6,
                  "group_scatter": 6, "three_nn": 8, "interp_scatter": 8}
FROZEN_PER_STEP = {**TRAIN_PER_STEP, "ball_query": 3, "group_scatter": 3,
                   "three_nn": 4, "interp_scatter": 4}
# card vs CPU train step (B=2, N=128, 48x48, SA npoints 32/16/8/8, points
# at std 3 cm so that the camera radii find neighbours at 128 points),
# bounds ~10x over the measurements on the H100:
# - loss parts, relative (measured 1.2e-7);
# - gradients, normwise over all: max|card - cpu| / max|cpu| (9.2e-5);
# - gradients per tensor, normwise, for every tensor whose largest
#   gradient is above REF_GRAD_FLOOR of the largest of all (384 of 396
#   tensors; measured <= 2.6e-2, main_estimator.pose_mlp1.0.weight; the
#   bound sits ~4x over it). Below the floor sit the biases before
#   train-mode BNs (gradients of rounding noise, ~1e-10) and two PReLU
#   slopes (one-element sums that cancel to ~3e-6 of the largest; 0.15);
# - the updated parameters: Adam's first step moves an element by
#   lr * g / (|g| + eps), ~lr whatever |g|, so an element whose gradient is
#   rounding noise takes +-lr on either side; the share of elements whose
#   updates differ by more than 0.1 lr is bounded (measured 0.187%);
# - running statistics, normwise per tensor (5.9e-6)
REF_SA_NPOINTS, REF_BATCH, REF_POINTS, REF_IMG = (32, 16, 8, 8), 2, 128, 48
REF_LOSS_TOL = 1e-5
REF_GRAD_TOL = 1e-3
REF_GRAD_FLOOR = 1e-5
REF_GRAD_TENSOR_TOL = 0.1
REF_UPDATE_SHARE = 1e-2
REF_STATS_TOL = 1e-4


@contextlib.contextmanager
def policy(dtype):
    """Run the block under the compute policy ``dtype``, then restore."""
    from istnet_tpu_torch.nn import precision
    old = precision.compute_dtype()
    precision.set_compute_dtype(dtype)
    try:
        yield
    finally:
        precision.set_compute_dtype(old)


def run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True)
    return proc.stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(smi.splitlines()[0])
    from istnet_tpu_torch.ops import _build
    nvcc = run([_build.find_nvcc(), "--version"]).splitlines()[-1]
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "not installed"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc} "
          f"| triton {triton}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from istnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"[build] {_build.LIB_NAME} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {info.get('seconds', 0.0):.1f} s, cached "
          f"{info.get('cached')})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())


def _points(rng, b, n):
    import torch
    return torch.from_numpy((rng.randn(b, n, 3) * 0.1).astype("float32"))


def _f32(a, device):
    import torch
    return torch.from_numpy(a.astype("float32")).to(device)


def _epilogue(rng, cout):
    import numpy as np
    return np.stack([rng.randn(cout) * 0.1,
                     1.0 / np.sqrt(rng.uniform(0.5, 1.5, cout)),
                     1.0 + rng.randn(cout) * 0.1, rng.randn(cout) * 0.1,
                     np.full(cout, 0.25)])


def kernel_cases(device):
    """Per kernel, the argument tuples of its path shapes, on ``device``."""
    import numpy as np
    import torch

    from istnet_tpu_torch.models.ist_net import CAM_RADII

    rng = np.random.RandomState(0)
    cases = {"fps": [], "ball_query_group": [], "fp_interpolate": [],
             "fold_upsample": []}
    for n, npoint in FPS_SHAPES:
        cases["fps"].append((_points(rng, BATCH, n).to(device), npoint))
    for (n, m, cf), radii in zip(BQG_SHAPES, CAM_RADII):
        xyz = _points(rng, BATCH, n).to(device)
        feats = (None if cf == 0 else torch.from_numpy(
            rng.randn(BATCH, n, cf).astype("float32")).to(device))
        cases["ball_query_group"].append(
            (radii, NSAMPLES, xyz, xyz[:, :m].contiguous(), feats))
    for n, m, c in FP_SHAPES:
        unknown = _points(rng, BATCH, n).to(device)
        feats = torch.from_numpy(rng.randn(BATCH, m, c).astype("float32"))
        cases["fp_interpolate"].append(
            (unknown, unknown[:, :m].contiguous(), feats.to(device)))
    h, w, cin, cout = FOLD_SHAPE
    ep = _epilogue(rng, cout)
    cases["fold_upsample"].append(
        (_f32(rng.randn(BATCH, h, w, cin), device),
         _f32(rng.uniform(-1, 1, (3, 3, cin, cout)) / np.sqrt(9 * cin), device),
         _f32(rng.randn(cout) * 0.1, device), _f32(ep, device)))
    return cases


def _folded(rng, c_in, channels, device):
    """Random BN-folded (W, b) layers, float32 on ``device``."""
    import numpy as np
    layers = []
    for c_out in channels:
        layers.append((_f32(rng.uniform(-1, 1, (c_in, c_out))
                            * np.sqrt(3.0 / c_in), device),
                       _f32(rng.randn(c_out) * 0.1, device)))
        c_in = c_out
    return tuple(layers)


def kernel_cases_bf16(device):
    """The bf16 path's cases: per kernel a list of (argument tuple, on the
    path). The fused SA case at stage 1's shape is #7's function; the model
    keeps stage 1 unfused, so it is checked and timed but off the path."""
    import numpy as np
    import torch

    from istnet_tpu_torch.models.ist_net import CAM_RADII

    bf16 = torch.bfloat16
    rng = np.random.RandomState(1)
    cases = {"ball_query_group": [], "fp_interpolate": [],
             "fold_upsample": [], "sa_fused": []}
    n, m, _ = BQG_SHAPES[0]
    xyz = _points(rng, BATCH, n).to(device)
    cases["ball_query_group"].append(
        ((CAM_RADII[0], NSAMPLES, xyz, xyz[:, :m].contiguous(), None, bf16),
         True))
    for n, m, c in FP_SHAPES:
        unknown = _points(rng, BATCH, n).to(device)
        feats = _f32(rng.randn(BATCH, m, c), device).to(bf16)
        cases["fp_interpolate"].append(
            ((unknown, unknown[:, :m].contiguous(), feats), True))
    h, w, cin, cout = FOLD_SHAPE
    cases["fold_upsample"].append(
        ((_f32(rng.randn(BATCH, h, w, cin), device).to(bf16),
          _f32(rng.uniform(-1, 1, (3, 3, cin, cout)) / np.sqrt(9 * cin),
               device).to(bf16),
          _f32(rng.randn(cout) * 0.1, device).to(bf16),
          _f32(_epilogue(rng, cout), device)), True))
    stages = [(shape, CAM_RADII[i + 1], True)
              for i, shape in enumerate(SA_FUSED_SHAPES)]
    for (n, m, cf, mlp), radii, on_path in stages + [(SA1_SHAPE, CAM_RADII[0],
                                                      False)]:
        xyz = _points(rng, BATCH, n).to(device)
        feats = (None if cf == 0 else
                 torch.relu(_f32(rng.randn(BATCH, n, cf), device)).to(bf16))
        folded = tuple(_folded(rng, 3 + cf, mlp, device) for _ in NSAMPLES)
        cases["sa_fused"].append(
            ((radii, NSAMPLES, xyz, xyz[:, :m].contiguous(), feats, folded),
             on_path))
    return cases


def train_kernel_cases(device):
    """The train step's kernels at its shapes: per kernel a list of
    (argument tuple, launches of that case in one default-recipe step).
    The inputs follow the path: a train batch's centred points through the
    camera extractor's SA stages and its NOCS points (``qo``) through the
    world extractor's, each stage's centres the plain FPS of its input,
    each FP stage's known points those of the stage below (so part of its
    unknown ones: distances of exactly 0). Features and cotangents are
    random float32 of the stage's widths; the scatters take the indices of
    the plain searches (equal to the kernels', checked in the same phase).
    SA stage 1 has no backward: its points are data."""
    import numpy as np

    from istnet_tpu_torch.entry import make_train_batch
    from istnet_tpu_torch.models.ist_net import CAM_RADII, WORLD_RADII
    from istnet_tpu_torch.ops import pointnet2 as plain

    rng = np.random.RandomState(2)
    b = TRAIN_BATCH
    inputs = make_train_batch(b, TRAIN_POINTS, TRAIN_IMG, seed=2,
                              device=device)["inputs"]
    cam = inputs["pts"] - inputs["pts"].mean(dim=1, keepdim=True)
    cases = {name: [] for name, k in TRAIN_PER_STEP.items() if k}
    for cloud, radii_list in ((cam, CAM_RADII), (inputs["qo"], WORLD_RADII)):
        levels = [cloud]
        for (n, m, cf), radii in zip(BQG_SHAPES, radii_list):
            xyz = levels[-1]
            new_xyz = plain.gather_points(xyz,
                                          plain.furthest_point_sample(xyz, m))
            levels.append(new_xyz)
            feats = None if cf == 0 else _f32(rng.randn(b, n, cf), device)
            cases["fps"].append(((xyz, m), 1))
            cases["ball_query_group"].append(
                ((radii, NSAMPLES, xyz, new_xyz, feats), 1))
            if cf == 0:
                continue
            cases["ball_query"].append(((radii, NSAMPLES, xyz, new_xyz), 1))
            idx = plain.ball_query_multi(radii, NSAMPLES, xyz, new_xyz)
            grads = [_f32(rng.randn(b, m, ns, 3 + cf), device)
                     for ns in NSAMPLES]
            cases["group_scatter"].append(((idx, grads, n), 1))
        for k, (n, m, c) in enumerate(FP_SHAPES):
            unknown, known = levels[3 - k], levels[4 - k]
            cases["fp_interpolate"].append(
                ((unknown, known, _f32(rng.randn(b, m, c), device)), 1))
            cases["three_nn"].append(((unknown, known), 1))
            dist, idx = plain.three_nn(unknown, known)
            weight = plain.three_interpolate_weights(dist)
            cases["interp_scatter"].append(
                ((_f32(rng.randn(b, n, c), device), idx, weight, m), 1))
    return cases


def _label(name: str, args) -> str:
    if name == "fps":
        return f"N={args[0].shape[1]} npoint={args[1]}"
    if name == "ball_query":
        radii, _, xyz, new_xyz = args
        return f"N={xyz.shape[1]} M={new_xyz.shape[1]} radii={radii}"
    if name == "group_scatter":
        idx, grads, n = args
        return (f"N={n} M={idx[0].shape[1]} C={grads[0].shape[-1]} "
                f"ns={[i.shape[-1] for i in idx]}")
    if name == "three_nn":
        return f"N={args[0].shape[1]} M={args[1].shape[1]}"
    if name == "interp_scatter":
        grad, _, _, m = args
        return f"N={grad.shape[1]} M={m} C={grad.shape[-1]}"
    if name in ("ball_query_group", "sa_fused"):
        xyz, new_xyz, feats = args[2:5]
        c = 3 + (0 if feats is None else feats.shape[-1])
        return f"N={xyz.shape[1]} M={new_xyz.shape[1]} C={c} radii={args[0]}"
    if name == "fp_interpolate":
        unknown, known, feats = args
        return f"N={unknown.shape[1]} M={known.shape[1]} C={feats.shape[-1]}"
    return f"x={tuple(args[0].shape)} cout={args[1].shape[-1]}"


def _check(name: str, got, want, bf16: bool) -> float:
    """Max abs error of one kernel case against its plain version; raise if
    it is outside the stated tolerance."""
    import torch
    if name == "fps":
        if not torch.equal(got, want):
            raise AssertionError(f"fps indices differ at {tuple(got.shape)}")
        return 0.0
    if name in ("ball_query", "three_nn"):
        # indices (and 3-NN distances) from the same arithmetic: equal
        for g, w_ in zip(got, want):
            if g.dtype != w_.dtype or not torch.equal(g, w_):
                raise AssertionError(f"{name} differs at {tuple(g.shape)} "
                                     f"{g.dtype}")
        return 0.0
    if name == "group_scatter":
        err = 0.0
        for g, w_ in zip(got, want):      # points_bar, centroid_bar
            d = (g - w_).abs().max().item()
            if g.dtype != w_.dtype or d > SCATTER_TOL * w_.abs().max().item():
                raise AssertionError(f"group_scatter max abs err {d} at "
                                     f"{tuple(g.shape)}")
            err = max(err, d)
        return err
    if name == "interp_scatter":
        err = (got - want).abs().max().item()
        if got.dtype != want.dtype or err > SCATTER_TOL * want.abs().max():
            raise AssertionError(f"interp_scatter max abs err {err} at "
                                 f"{tuple(got.shape)}")
        return err
    if name == "ball_query_group":
        for g, w_ in zip(got, want):
            if g.dtype != w_.dtype or not torch.equal(g, w_):
                diff = (g.float() - w_.float()).abs().max().item()
                raise AssertionError(f"ball_query_group differs at "
                                     f"{tuple(g.shape)} {g.dtype}: max {diff}")
        return 0.0
    if name == "sa_fused":
        err = 0.0
        for g, w_ in zip(got, want):
            d = (g.float() - w_.float()).abs()
            scale = w_.float().abs().max().item()
            share = (d > 0).float().mean().item()
            print(f"[kernels]   sa_fused radius {tuple(g.shape)}: max abs err "
                  f"{d.max().item():.3g} (max |plain| {scale:.3g}), "
                  f"{share:.2%} of elements differ")
            if g.dtype != torch.bfloat16 or d.max() > SA_TOL * max(1.0, scale):
                raise AssertionError(f"sa_fused max abs err {d.max().item()} "
                                     f"(max |plain| {scale})")
            err = max(err, d.max().item())
        return err
    if got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} vs plain {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if name == "fp_interpolate":
        ok = err <= (BF16_FP_TOL if bf16 else FP_REL_TOL) * scale
    else:
        ok = err <= (BF16_FOLD_TOL if bf16 else FOLD_TOL) * max(1.0, scale)
    if not ok:
        raise AssertionError(f"{name} max abs err {err} (max |plain| {scale}) "
                             f"at {tuple(got.shape)}")
    return err


def phase_kernels(cases, bf16: bool = False, tag: str = "") -> dict:
    """Each case through the kernel and its plain version; per kernel the
    worst error. ``cases``: name -> list of (args, on the path)."""
    import torch

    from istnet_tpu_torch.ops import dispatch
    tag = "bf16 " if bf16 else tag
    errs = {}
    for name, case_list in cases.items():
        mod = dispatch.KERNELS[name]
        kern = dispatch.wrapper(name)
        worst = 0.0
        for args, _ in case_list:
            got, want = kern(*args), mod.plain(*args)
            torch.cuda.synchronize()
            err = _check(name, got, want, bf16)
            worst = max(worst, err)
            print(f"[kernels] {tag}{name} {_label(name, args)}: match, max abs "
                  f"err {err:.3g}")
        errs[name] = worst
    return errs


def phase_forward(model, device, per_forward: dict, tag: str = "") -> dict:
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_inputs
    batches = [make_inputs(BATCH, seed=1 + i, device=device)
               for i in range(SERVED_BATCHES)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        for inp in batches:
            outs.append(model(inp))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[forward] {tag}served {SERVED_BATCHES} batches of {BATCH} in "
          f"{seconds:.3f} s (first calls included); launches {counts}")
    for name, k in per_forward.items():
        if counts[name] != k * SERVED_BATCHES:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{k * SERVED_BATCHES}")
    eye = torch.eye(3, device=device)
    for out in outs:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != {"pred_qo": (BATCH, 1024, 3),
                      "pred_rotation": (BATCH, 3, 3),
                      "pred_translation": (BATCH, 3),
                      "pred_size": (BATCH, 3)}:
            raise AssertionError(f"output shapes {shapes}")
        for k, v in out.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise AssertionError(f"{k} is not finite float32 ({v.dtype})")
        r = out["pred_rotation"]
        orth = (r.transpose(1, 2) @ r - eye).abs().max().item()
        if orth > 1e-5:
            raise AssertionError(f"R^T R - I = {orth}")
    print(f"[forward] {tag}outputs finite float32, shapes right, "
          f"max |R^T R - I| <= 1e-5")
    return counts


def phase_reference(model, device, atol: float = CPU_ATOL,
                    tag: str = "") -> None:
    import torch

    from istnet_tpu_torch.entry import build_model, make_inputs
    cpu = build_model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    inp = make_inputs(2, seed=7)
    with torch.inference_mode():
        want = cpu(inp)
        got = model({k: v.to(device) for k, v in inp.items()})
    worst = 0.0
    for k, w in want.items():
        err = (got[k].cpu() - w).abs().max().item()
        print(f"[reference] {tag}B=2 {k}: card vs CPU max abs err {err:.3g}")
        worst = max(worst, err)
    if worst > atol:
        raise AssertionError(f"card vs CPU forward differ by {worst} > {atol}")


def phase_drift(model, device) -> None:
    """The bf16 forward against the float32 one, same weights and inputs,
    both on the card."""
    import torch

    from istnet_tpu_torch.entry import make_inputs
    inp = make_inputs(BATCH, seed=1, device=device)
    with torch.inference_mode():
        with policy(torch.float32):
            f32 = model(inp)
        b16 = model(inp)
    for k, v in f32.items():
        print(f"[reference] bf16 vs f32 B={BATCH} {k}: max abs drift "
              f"{(b16[k] - v).abs().max().item():.3g} (max |f32| "
              f"{v.abs().max().item():.3g})")


def phase_timings(model, cases, device, tag: str = "") -> dict:
    """The B=32 forward and its sections, then every kernel case against
    its plain version; per kernel the summed ms of the cases on the path."""
    import torch

    from istnet_tpu_torch.entry import make_inputs
    from istnet_tpu_torch.ops import dispatch
    inp = make_inputs(BATCH, seed=1, device=device)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model(inp), iters=10)
    print(f"[timings] {tag}B={BATCH} forward {fwd:.3f} ms "
          f"({BATCH / fwd * 1e3:.1f} inf/s)")
    # the forward's sections, each timed alone on the same inputs
    with torch.inference_mode():
        pts = inp["pts"] - inp["pts"].mean(dim=1, keepdim=True)
        cls = inp["category_label"]
        enc = model.rgb_cam_extractor
        rgb_local = enc.sparse_points(inp["rgb"], inp["choose"])
        pts_local = model.pts_cam_extractor(pts)

        def heads():
            pts_w, pts_w_local = model.implicit_transform(rgb_local, pts_local,
                                                          pts, cls)
            return model.main_estimator(pts, pts_w, rgb_local, pts_local,
                                        pts_w_local)

        sections = {
            "rgb encoder (trunk+PSP+up_1+up_2+sparse head)":
                lambda: enc.sparse_points(inp["rgb"], inp["choose"]),
            "  trunk": lambda: enc.model.feats(inp["rgb"]),
            "PointNet2MSG (4 SA + 4 FP)": lambda: model.pts_cam_extractor(pts),
            "implicit transform + pose heads": heads,
        }
        for label, fn in sections.items():
            print(f"[timings] {tag}section {label}: "
                  f"{cuda_ms(fn, iters=10):.3f} ms")
    return time_kernels(cases, tag)


def time_kernels(cases, tag: str = "") -> dict:
    """Every kernel case against its plain version; per kernel the ms of
    one forward (or train step): each case's time times its count there
    (``on_path``: True/False for once/never, or a launch count)."""
    from istnet_tpu_torch.ops import dispatch
    times = {}
    for name, case_list in cases.items():
        mod = dispatch.KERNELS[name]
        kern = dispatch.wrapper(name)
        k_ms = p_ms = 0.0
        for args, on_path in case_list:
            km = cuda_ms(lambda: kern(*args), iters=20)
            pm = cuda_ms(lambda: mod.plain(*args), iters=3, warmup=1)
            note = ("" if on_path is True else " (off the path)"
                    if not on_path else f" (x{on_path} a step)")
            print(f"[timings] {tag}{name} {_label(name, args)}: kernel "
                  f"{km:.4f} ms, plain {pm:.4f} ms{note}")
            k_ms += km * on_path
            p_ms += pm * on_path
        times[name] = (k_ms, p_ms)
    return times


def phase_stage1_choice(model, device) -> None:
    """SA stage 1 under bf16, fused kernel against the unfused stage the
    model runs (bf16 grouping + SharedMLP + max), same weights and inputs:
    the choice the JAX package measured on its own chip
    (``istnet_tpu/ops/dispatch.py:141-148``)."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_inputs
    from istnet_tpu_torch.nn.pointnet2_msg import _fold_shared_mlp
    sa = model.pts_cam_extractor.SA_modules[0]
    inp = make_inputs(BATCH, seed=1, device=device)
    with torch.inference_mode():
        xyz = inp["pts"] - inp["pts"].mean(dim=1, keepdim=True)
        new_xyz = ops.gather_points(xyz, ops.furthest_point_sample(xyz,
                                                                  sa.npoint))
        folded = [_fold_shared_mlp(mlp) for mlp in sa.mlps]

        def unfused():
            grouped = ops.ball_query_group(sa.radii, sa.nsamples, xyz, new_xyz,
                                           None, torch.bfloat16)
            return torch.cat([mlp(g).amax(dim=2)
                              for g, mlp in zip(grouped, sa.mlps)], dim=-1)

        def fused():
            return torch.cat(ops.sa_msg_fused(sa.radii, sa.nsamples, xyz,
                                              new_xyz, None, folded), dim=-1)

        a, b = unfused().float(), fused().float()
        err = (a - b).abs().max().item()
        scale = a.abs().max().item()
        # BN folded into bf16 weights vs BN after a bf16 matmul: the JAX
        # module test's bound (tests/test_sa_fused.py:186-188)
        if err > 5e-2 * max(1.0, scale):
            raise AssertionError(f"stage 1 fused vs unfused: {err}")
        u_ms, f_ms = cuda_ms(unfused, iters=20), cuda_ms(fused, iters=20)
    print(f"[timings] bf16 SA stage 1 (B={BATCH}, N=1024, M=512): unfused "
          f"(grouping + SharedMLP + max) {u_ms:.4f} ms, fused kernel "
          f"{f_ms:.4f} ms; outputs agree to {err:.3g} (max {scale:.3g})")


def _dropout_off(model) -> None:
    from istnet_tpu_torch.nn.layers import Dropout2d
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.eval()


def _check_step(model, opt, cfg, step, parts, before, stats, tag) -> None:
    """One train step's invariants: finite loss parts and gradients, the
    trained parameters moved (each with a gradient above rounding), the
    frozen ones did not, and every BatchNorm that ran took the scheduled
    EMA of its published batch statistics."""
    import torch

    from istnet_tpu_torch.train.train_state import batch_norms
    bad = [k for k, v in parts.items() if not torch.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: loss parts {bad} not finite")
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    no_grad, still = [], []
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        if id(p) not in trained:
            if moved:
                raise AssertionError(f"{tag}: frozen {name} moved")
            continue
        if p.grad is None:
            no_grad.append(name)
            continue
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"{tag}: gradient of {name} not finite")
        if not moved and p.grad.abs().max() > 1e-6:
            still.append(name)
    # the trunk's classifier is loaded and never run (resnet_psp.py)
    no_grad = [n for n in no_grad if ".feats.fc." not in n]
    if no_grad or still:
        raise AssertionError(f"{tag}: no gradient {no_grad}; did not move "
                             f"{still}")
    m = cfg.momentum(step)
    ran = 0
    for bn, (mean, var, count) in zip(batch_norms(model), stats):
        if bn.batch_mean is None:
            if not torch.equal(bn.running_mean, mean):
                raise AssertionError(f"{tag}: an idle BatchNorm moved")
            continue
        ran += 1
        for got, old, batch in ((bn.running_mean, mean, bn.batch_mean),
                                (bn.running_var, var, bn.batch_var)):
            want = (1.0 - m) * old + m * batch
            if torch.equal(got, old) or not torch.allclose(got, want,
                                                           rtol=1e-6,
                                                           atol=1e-7):
                raise AssertionError(f"{tag}: BatchNorm statistics off the "
                                     f"EMA with momentum {m}")
        if int(bn.num_batches_tracked) != int(count) + 1:
            raise AssertionError(f"{tag}: num_batches_tracked")
    print(f"[train] {tag}: loss {float(parts['total']):.6g} "
          f"({', '.join(f'{k} {float(v):.4g}' for k, v in parts.items())}); "
          f"{len(trained)} trained tensors finite and moved; {ran} "
          f"BatchNorms took the EMA (momentum {m:.4g})")


def phase_train_steps(device) -> dict:
    """3 default-recipe and 2 frozen-recipe steps at the training width;
    returns the launches of all 5 steps."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        batch_norms,
        make_optimizer,
        train_step,
    )
    totals: dict = {}
    torch.cuda.reset_peak_memory_stats(device)
    for cfg, steps, per_step in ((TrainConfig(), TRAIN_STEPS, TRAIN_PER_STEP),
                                 (TrainConfig.frozen(), FROZEN_STEPS,
                                  FROZEN_PER_STEP)):
        recipe = "frozen" if cfg.freeze_world_enhancer else "default"
        model = build_train_model(device, seed=0,
                                  freeze_world_enhancer=cfg.freeze_world_enhancer,
                                  sa_npoints=TRAIN_SA_NPOINTS)
        opt = make_optimizer(model, cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        for step in range(steps):
            batch = make_train_batch(TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG,
                                     seed=10 + step, device=device)
            before = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            stats = [(bn.running_mean.clone(), bn.running_var.clone(),
                      bn.num_batches_tracked.clone())
                     for bn in batch_norms(model)]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            parts = train_step(model, opt, batch, step, gen, cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = ops.launch_counts()
            tag = f"{recipe} step {step} (B={TRAIN_BATCH}, {seconds:.3f} s)"
            if counts != per_step:
                raise AssertionError(f"{tag}: launches {counts}, expected "
                                     f"{per_step}")
            _check_step(model, opt, cfg, step, parts, before, stats, tag)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        print(f"[train] {recipe}: launches per step as expected {per_step}")
        del model, opt
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[train] peak memory allocated {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return totals


def phase_train_reference(device) -> None:
    """One default-recipe step on the card against the same step of the
    port's CPU path: same weights, batch and LR, dropout off."""
    import torch

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        make_optimizer,
        train_step,
    )
    cfg = TrainConfig()
    batch = make_train_batch(REF_BATCH, REF_POINTS, REF_IMG, seed=5)
    batch["inputs"]["pts"] = batch["inputs"]["pts"] * 0.3
    init = None
    runs = []
    for dev in ("cpu", device):
        model = build_train_model(dev, seed=3, sa_npoints=REF_SA_NPOINTS)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        _dropout_off(model)
        b = {part: {k: v.to(dev) for k, v in d.items()}
             for part, d in batch.items()}
        parts = train_step(model, make_optimizer(model, cfg), b, 0,
                           torch.Generator(device=dev), cfg)
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        runs.append(({k: float(v) for k, v in parts.items()}, grads, state))
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = runs
    loss_err = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12)
                   for k, v in l_cpu.items())
    if set(g_cpu) != set(g_gpu):
        raise AssertionError("card and CPU differ in which parameters have "
                             "a gradient")
    g_err = {k: (g_gpu[k] - g).abs().max().item()
             / max(g.abs().max().item(), 1e-30) for k, g in g_cpu.items()}
    g_top = max(g.abs().max().item() for g in g_cpu.values())
    g_all = (max((g_gpu[k] - g).abs().max().item() for k, g in g_cpu.items())
             / g_top)
    above = {k: e for k, e in g_err.items()
             if g_cpu[k].abs().max().item() > REF_GRAD_FLOOR * g_top}
    lr = cfg.lr(0)
    u_off, s_err = [], {}
    for k, v in s_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (s_gpu[k] - v).abs()
        if "running" in k:
            s_err[k] = d.max().item() / max(v.abs().max().item(), 1e-30)
        else:
            u_off.append(d.flatten() / lr)
    u_off = torch.cat(u_off)
    u_max, u_share = u_off.max().item(), (u_off > 0.1).float().mean().item()

    def worst(errs, n=5):
        return ", ".join(
            f"{k} {e:.3g} (max|g| {g_cpu[k].abs().max().item():.3g}, "
            f"{g_cpu[k].numel()} el.)"
            for k, e in sorted(errs.items(), key=lambda kv: -kv[1])[:n])

    print(f"[train-reference] B={REF_BATCH} N={REF_POINTS} {REF_IMG}x"
          f"{REF_IMG}: loss parts rel err {loss_err:.3g}; gradients "
          f"normwise over all {g_all:.3g} (max|g| {g_top:.3g}), per tensor "
          f"median {sorted(g_err.values())[len(g_err) // 2]:.3g}, worst "
          + worst(g_err))
    print(f"[train-reference]   {len(above)} of {len(g_err)} tensors with "
          f"max|g| > {REF_GRAD_FLOOR:g} of the largest: worst "
          f"{worst(above, 3)}")
    worst_s = max(s_err, key=s_err.get)
    worst_t = max(above, key=above.get)
    print(f"[train-reference] updated parameters: {u_share:.3%} of "
          f"{u_off.numel()} elements off by more than 0.1 lr, the most "
          f"{u_max:.3g} lr; running statistics normwise <= "
          f"{s_err[worst_s]:.3g} ({worst_s})")
    if (loss_err > REF_LOSS_TOL or g_all > REF_GRAD_TOL
            or above[worst_t] > REF_GRAD_TENSOR_TOL
            or u_share > REF_UPDATE_SHARE
            or s_err[worst_s] > REF_STATS_TOL):
        raise AssertionError(
            f"card vs CPU train step: loss {loss_err} (tol {REF_LOSS_TOL}), "
            f"gradients {g_all} ({REF_GRAD_TOL}), per tensor {above[worst_t]} "
            f"at {worst_t} ({REF_GRAD_TENSOR_TOL}), updates off {u_share} "
            f"({REF_UPDATE_SHARE}), statistics {s_err[worst_s]} "
            f"({REF_STATS_TOL})")


def phase_train_timings(device) -> None:
    """Median ms of ``train_step`` at the training width, then the split of
    the same step into its parts (``start_step``, then timed by CUDA
    events: ``step_loss``, the backward, ``finish_step``)."""
    import statistics

    import torch

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        finish_step,
        make_optimizer,
        start_step,
        step_loss,
        train_step,
    )
    cfg = TrainConfig()
    model = build_train_model(device, seed=1, sa_npoints=TRAIN_SA_NPOINTS)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = make_train_batch(TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG, seed=30,
                             device=device)
    for step in range(2):
        train_step(model, opt, batch, step, gen, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    step_ms = []
    for step in range(2, 2 + TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        train_step(model, opt, batch, step, gen, cfg)
        ev[1].record()
        torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    split = []
    for step in range(2 + TIMED_STEPS, 2 + 2 * TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        start_step(model, opt, step, cfg)
        ev[0].record()
        total, _ = step_loss(model, batch, gen, cfg)
        ev[1].record()
        total.backward()
        ev[2].record()
        finish_step(model, opt, step, cfg)
        ev[3].record()
        torch.cuda.synchronize()
        split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    med = statistics.median(step_ms)
    fwd, bwd, upd = (statistics.median(s[i] for s in split) for i in range(3))
    print(f"[timings] train B={TRAIN_BATCH} f32 step: median {med:.3f} ms "
          f"over {TIMED_STEPS} (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}; {TRAIN_BATCH / med * 1e3:.1f} samples/s); "
          f"split medians: forward + loss {fwd:.3f} ms, backward {bwd:.3f} "
          f"ms, Adam + BN EMA {upd:.3f} ms; peak memory {peak:.2f} GiB")


def main() -> int:
    device_info = phase_device()
    import torch

    from istnet_tpu_torch.entry import build_model, build_serving_model
    from istnet_tpu_torch.ops import dispatch
    phase_build()
    device = torch.device("cuda", 0)
    kernels = []

    def record(path, dtype, errs, counts, times, names):
        for name in names:
            mod = dispatch.KERNELS[name]
            k_ms, p_ms = times[name]
            kernels.append({"name": name, "path": path, "dtype": dtype,
                            "route": "cuda", "source": mod.SOURCE,
                            "replaces": mod.REPLACES, "launches": counts[name],
                            "max_abs_err": errs[name], "ms": k_ms,
                            "plain_ms": p_ms})

    with policy(torch.float32):
        cases = {name: [(args, True) for args in arg_list]
                 for name, arg_list in kernel_cases(device).items()}
        errs = phase_kernels(cases)
        model = build_model(device)
        counts = phase_forward(model, device, F32_PER_FORWARD)
        phase_reference(model, device)
        times = phase_timings(model, cases, device)
    record("float32", "float32", errs, counts, times, list(cases))

    with policy(torch.bfloat16):
        cases16 = kernel_cases_bf16(device)
        errs16 = phase_kernels(cases16, bf16=True)
        model16 = build_serving_model(torch.bfloat16, device)
        counts16 = phase_forward(model16, device, BF16_PER_FORWARD, "bf16 ")
        phase_reference(model16, device, BF16_CPU_ATOL, "bf16 ")
        phase_drift(model16, device)
        times16 = phase_timings(model16, cases16, device, "bf16 ")
        phase_stage1_choice(model16, device)
    # FPS runs on the float32 geometry under both policies
    errs16["fps"], times16["fps"] = errs["fps"], times["fps"]
    record("bfloat16", "float32", errs16, counts16, times16, ["fps"])
    record("bfloat16", "bfloat16", errs16, counts16, times16, list(cases16))

    with policy(torch.float32):
        train_cases = train_kernel_cases(device)
        errs_t = phase_kernels(train_cases, tag="train ")
        counts_t = phase_train_steps(device)
        phase_train_reference(device)
        phase_train_timings(device)
        times_t = time_kernels(train_cases, "train ")
    record("train", "float32", errs_t, counts_t, times_t, list(train_cases))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
