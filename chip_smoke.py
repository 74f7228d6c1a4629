#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``istnet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each printing its own lines; any failure exits nonzero:

1. device: the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions;
2. build: compile the CUDA kernels from ``istnet_tpu_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the main path gives it;
4. forward: the full-width ISTNet eval forward (B=32, N=1024, 192x192,
   float32) serving 3 batches, with the launch counts of every kernel;
5. reference: the same model and inputs at B=2, on the card against the
   port's plain-PyTorch CPU forward;
6. timings: the B=32 forward and its sections, each kernel against its
   plain version (CUDA events after warmup).

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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
    f32 = lambda a: torch.from_numpy(a.astype("float32")).to(device)
    ep = np.stack([rng.randn(cout) * 0.1, 1.0 / np.sqrt(rng.uniform(0.5, 1.5, cout)),
                   1.0 + rng.randn(cout) * 0.1, rng.randn(cout) * 0.1,
                   np.full(cout, 0.25)])
    cases["fold_upsample"].append(
        (f32(rng.randn(BATCH, h, w, cin)),
         f32(rng.uniform(-1, 1, (3, 3, cin, cout)) / np.sqrt(9 * cin)),
         f32(rng.randn(cout) * 0.1), f32(ep)))
    return cases


def _label(name: str, args) -> str:
    if name == "fps":
        return f"N={args[0].shape[1]} npoint={args[1]}"
    if name == "ball_query_group":
        xyz, new_xyz, feats = args[2:5]
        c = 3 + (0 if feats is None else feats.shape[-1])
        return f"N={xyz.shape[1]} M={new_xyz.shape[1]} C={c}"
    if name == "fp_interpolate":
        unknown, known, feats = args
        return f"N={unknown.shape[1]} M={known.shape[1]} C={feats.shape[-1]}"
    return f"x={tuple(args[0].shape)} cout={args[1].shape[-1]}"


def phase_kernels(cases) -> dict:
    import torch

    from istnet_tpu_torch.ops import dispatch
    errs = {}
    for name, args_list in cases.items():
        mod = dispatch.KERNELS[name]
        kern = dispatch.wrapper(name)
        worst = 0.0
        for args in args_list:
            got, want = kern(*args), mod.plain(*args)
            torch.cuda.synchronize()
            if name == "fps":
                if not torch.equal(got, want):
                    raise AssertionError(f"fps indices differ at "
                                         f"{tuple(args[0].shape)}")
                err = 0.0
            elif name == "ball_query_group":
                err = 0.0
                for g, w_ in zip(got, want):
                    if not torch.equal(g, w_):
                        diff = (g - w_).abs().max().item()
                        raise AssertionError(
                            f"ball_query_group differs at {tuple(g.shape)}: "
                            f"max {diff}")
            else:
                err = (got - want).abs().max().item()
                scale = want.abs().max().item()
                if name == "fp_interpolate":
                    ok = err <= FP_REL_TOL * scale
                else:
                    ok = err <= FOLD_TOL * max(1.0, scale)
                if not ok:
                    raise AssertionError(f"{name} max abs err {err} "
                                         f"(max |plain| {scale}) at "
                                         f"{tuple(args[0].shape)}")
            worst = max(worst, err)
            print(f"[kernels] {name} {_label(name, args)}: match, max abs "
                  f"err {err:.3g}")
        errs[name] = worst
    return errs


def phase_forward(model, device) -> dict:
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
    print(f"[forward] served {SERVED_BATCHES} batches of {BATCH} in "
          f"{seconds:.3f} s (first calls included); launches {counts}")
    per_forward = {"fps": 4, "ball_query_group": 4, "fp_interpolate": 4,
                   "fold_upsample": 1}
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
            if not torch.isfinite(v).all():
                raise AssertionError(f"{k} is not finite")
        r = out["pred_rotation"]
        orth = (r.transpose(1, 2) @ r - eye).abs().max().item()
        if orth > 1e-5:
            raise AssertionError(f"R^T R - I = {orth}")
    print("[forward] outputs finite, shapes right, max |R^T R - I| <= 1e-5")
    return counts


def phase_reference(model, device) -> None:
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
        print(f"[reference] B=2 {k}: card vs CPU max abs err {err:.3g}")
        worst = max(worst, err)
    if worst > CPU_ATOL:
        raise AssertionError(f"card vs CPU forward differ by {worst} > "
                             f"{CPU_ATOL}")


def phase_timings(model, cases, device) -> dict:
    import torch

    from istnet_tpu_torch.entry import make_inputs
    from istnet_tpu_torch.ops import dispatch
    inp = make_inputs(BATCH, seed=1, device=device)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model(inp), iters=10)
    print(f"[timings] B={BATCH} forward {fwd:.3f} ms "
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
            print(f"[timings] section {label}: {cuda_ms(fn, iters=10):.3f} ms")
    times = {}
    for name, args_list in cases.items():
        mod = dispatch.KERNELS[name]
        kern = dispatch.wrapper(name)
        k_ms = p_ms = 0.0
        for args in args_list:
            km = cuda_ms(lambda: kern(*args), iters=20)
            pm = cuda_ms(lambda: mod.plain(*args), iters=3, warmup=1)
            print(f"[timings] {name} {_label(name, args)}: kernel "
                  f"{km:.4f} ms, plain {pm:.4f} ms")
            k_ms += km
            p_ms += pm
        times[name] = (k_ms, p_ms)
    return times


def main() -> int:
    device_info = phase_device()
    import torch

    from istnet_tpu_torch.entry import build_model
    from istnet_tpu_torch.ops import dispatch
    phase_build()
    device = torch.device("cuda", 0)
    cases = kernel_cases(device)
    errs = phase_kernels(cases)
    model = build_model(device)
    counts = phase_forward(model, device)
    phase_reference(model, device)
    times = phase_timings(model, cases, device)

    kernels = []
    for name, mod in dispatch.KERNELS.items():
        k_ms, p_ms = times[name]
        kernels.append({"name": name, "route": "cuda", "source": mod.SOURCE,
                        "replaces": mod.REPLACES, "launches": counts[name],
                        "max_abs_err": errs[name], "ms": k_ms,
                        "plain_ms": p_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
