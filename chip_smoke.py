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
   kernel at stage 1 against the unfused stage 1.

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


def _label(name: str, args) -> str:
    if name == "fps":
        return f"N={args[0].shape[1]} npoint={args[1]}"
    if name in ("ball_query_group", "sa_fused"):
        xyz, new_xyz, feats = args[2:5]
        c = 3 + (0 if feats is None else feats.shape[-1])
        return f"N={xyz.shape[1]} M={new_xyz.shape[1]} C={c}"
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


def phase_kernels(cases, bf16: bool = False) -> dict:
    """Each case through the kernel and its plain version; per kernel the
    worst error. ``cases``: name -> list of (args, on the path)."""
    import torch

    from istnet_tpu_torch.ops import dispatch
    tag = "bf16 " if bf16 else ""
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
    times = {}
    for name, case_list in cases.items():
        mod = dispatch.KERNELS[name]
        kern = dispatch.wrapper(name)
        k_ms = p_ms = 0.0
        for args, on_path in case_list:
            km = cuda_ms(lambda: kern(*args), iters=20)
            pm = cuda_ms(lambda: mod.plain(*args), iters=3, warmup=1)
            note = "" if on_path else " (off the path)"
            print(f"[timings] {tag}{name} {_label(name, args)}: kernel "
                  f"{km:.4f} ms, plain {pm:.4f} ms{note}")
            if on_path:
                k_ms += km
                p_ms += pm
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

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
