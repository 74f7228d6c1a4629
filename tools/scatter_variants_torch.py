#!/usr/bin/env python3
"""Device time of the two backward scatters of the float32 train step, stage
by stage, beside the yardsticks and the rival that ``PERF.md`` sets them
against:

    python3 tools/scatter_variants_torch.py [--sweep]

Needs one CUDA card and nvcc. For every scatter call of one B=24
default-recipe step (``chip_smoke.train_kernel_cases``: SA stages 2-4 and
FP stages 1-4 of both extractors), device microseconds a call by
torch.profiler (``chip_smoke.device_us``), with float32 cotangents and, where
the package's wrapper takes them, bf16:

- the package's wrapper, by kernel;
- ``index_add_`` of the same rows (``chip_smoke.library_call``);
- ``read_flat``: the cotangent read once, 16 bytes a thread, nothing stored;
- grouping only: ``group_read_only``, the previous atomic scatter with its
  atomics replaced by register sums, and ``group_atomic``, the atomic rival
  (one warp a 16-slot group, the zero fill kept), checked against the plain
  version first (``tools/scatter_variants.cu`` says what each does);
- float32 calls only, probes of the wrapper (``probes`` says which).

The variants are built from ``tools/scatter_variants.cu`` into the package's
build directory. With ``--sweep`` the script instead builds the two
scatters again for each entry of ``SWEEP`` (a copy of their sources with
constants or lines replaced) and prints the device us of their launches on
the float32 calls of the step, variant by variant; a variant that keeps the
result is checked against the plain version first.

The package and ``chip_smoke`` are imported the usual way, this checkout's
last: with ``PYTHONPATH`` set to the root of another copy of the repository
(say the previous commit, unpacked with ``git archive``) the script times
that copy's wrappers. The first output lines are the card's name and power
limit and the directory of the package timed; then a line a call, then the
sums over the step.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = os.path.join(REPO, "tools", "scatter_variants.cu")


# name -> (checked against plain, [(file, old text, new text), ...])
HDR = "scatter_invert.cuh"
SWEEP = {
    "as built": (True, []),
    "__match_any_sync for the ballots": (True, [
        (HDR, "  unsigned same = 0xffffffffu;\n  if (partial) {",
         "  return __match_any_sync(0xffffffffu, key);\n  unsigned same = 0xffffffffu;\n"
         "  if (partial) {")]),
    "32 inversion warps always": (True, [(HDR, "const int nw = e / kInvEntries;",
                                          "const int nw = kInvWarps;")]),
    "chunks of 16 entries": (True, [(HDR, "kChunk = 32;", "kChunk = 16;")]),
    "4 rows in flight": (True, [(HDR, "kU = 2;", "kU = 4;")]),
    "8 gather warps a block": (True, [(src, "kGatherWarps = 4;", "kGatherWarps = 8;")
                                      for src in ("group_scatter.cu",
                                                  "interp_scatter.cu")]),
    "aligned rows realigned too": (True, [(HDR, "return c % 4 == 0 ? kAligned :",
                                           "return")]),
    "tail vector always": (True, [(HDR, "kShiftedTail : kShifted;",
                                   "kShiftedTail : kShiftedTail;")]),
    "no centroid sums (time only)": (False, [
        ("group_scatter.cu",
         "  const int j = (blockIdx.x - chunk_blocks) * kGatherWarps + warp;\n",
         "  return;\n  const int j = (blockIdx.x - chunk_blocks) * kGatherWarps + warp;\n")]),
}
SWEEP_SOURCES = ("common.cu", "group_scatter.cu", "interp_scatter.cu",
                 "scatter_invert.cu", HDR)


def sweep(cases) -> None:
    """Each SWEEP variant built into the package's build directory and its
    two scatters timed on the step's float32 calls."""
    from _sweep_torch import edited_build

    from istnet_tpu_torch.ops import _build, group_scatter, interp_scatter
    from istnet_tpu_torch.ops import pointnet2 as plain

    import chip_smoke as cs
    for name, (checked, edits) in SWEEP.items():
        with edited_build(name, edits, SWEEP_SOURCES):
            group_scatter._workspace_bytes.cache_clear()
            interp_scatter._workspace_bytes.cache_clear()
            totals: dict = {}
            lines = []
            for kname, kern, ref in (
                    ("group_scatter", group_scatter.group_scatter_cuda,
                     plain.group_scatter),
                    ("interp_scatter", interp_scatter.interp_scatter_cuda,
                     plain.three_interpolate_grad)):
                for args, launches in cases[kname]:
                    if not launches:
                        continue
                    if checked:
                        got, want = kern(*args), ref(*args)
                        for g, w in zip(*((got, want)
                                          if kname == "group_scatter"
                                          else ([got], [want]))):
                            err = (g - w).abs().max().item()
                            if err > cs.SCATTER_TOL * w.abs().max().item():
                                raise AssertionError(f"{name} {kname}: {err}")
                    by_kernel = cs.device_us(lambda: kern(*args))
                    for k, v in by_kernel.items():
                        totals[k] = totals.get(k, 0.0) + v * launches
                    lines.append(f"{kname} {cs._label(kname, args)}: "
                                 + ", ".join(f"{k} {v:.1f}" for k, v in
                                             sorted(by_kernel.items())))
            seconds = _build.build_info.get("seconds", 0)
        print(f"sweep {name!r} (built in {seconds:.1f} s): step sums "
              + ", ".join(f"{k} {v:.1f}" for k, v in sorted(totals.items())))
        for line in lines:
            print(f"  {line}")
    group_scatter._workspace_bytes.cache_clear()
    interp_scatter._workspace_bytes.cache_clear()


def build_variants():
    from istnet_tpu_torch.ops import _build
    out = _build.BUILD / "variants"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libscatter_variants.so"
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-Xcompiler", "-fPIC", "-shared", "-Xptxas", "-v", "-o",
                    str(lib), VARIANTS], check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("scatter_variants_torch: no CUDA card")
    sys.path.append(REPO)
    import chip_smoke as cs
    import istnet_tpu_torch
    from istnet_tpu_torch.ops import dispatch
    from istnet_tpu_torch.ops import pointnet2 as plain
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    print(f"package {os.path.dirname(istnet_tpu_torch.__file__)}")
    lib = build_variants()
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.variants_read_flat.argtypes = [P, L, P, P]
    lib.variants_group_read_only.argtypes = [P, P, P, P, I, I, I, I, I, I, P, P]
    lib.variants_group_atomic.argtypes = [P, P, P, P, I, I, I, I, I, I, I, P,
                                          P, P]
    device = torch.device("cuda", 0)
    sink = torch.zeros(4, device=device)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def check(err, name):
        if err != 0:
            raise RuntimeError(f"{name}: CUDA error {err}")

    def read_flat(tensors):
        flat = [t.reshape(-1).view(torch.float32) for t in tensors]
        flat = [f[: f.numel() // 4 * 4] for f in flat]

        def call():
            for f in flat:
                check(lib.variants_read_flat(f.data_ptr(), f.numel(),
                                             sink.data_ptr(), stream()),
                      "read_flat")
        return call

    def group_args(idx, grads):
        (i0, i1), (g0, g1) = idx, grads
        return (i0.data_ptr(), i1.data_ptr(), g0.data_ptr(), g1.data_ptr(),
                i0.shape[-1], i1.shape[-1])

    def group_read_only(idx, grads):
        b, m, _ = idx[0].shape
        c = grads[0].shape[-1]
        bf16 = int(grads[0].dtype == torch.bfloat16)
        return lambda: check(lib.variants_group_read_only(
            *group_args(idx, grads), b, m, c, bf16, sink.data_ptr(),
            stream()), "group_read_only")

    def group_atomic(idx, grads, n):
        b, m, _ = idx[0].shape
        c = grads[0].shape[-1]
        bf16 = int(grads[0].dtype == torch.bfloat16)
        pb = torch.empty(b, n, c, device=device)
        cb = torch.empty(b, m, 3, device=device)

        def call():
            pb.zero_()
            cb.zero_()
            check(lib.variants_group_atomic(
                *group_args(idx, grads), b, n, m, c, bf16, pb.data_ptr(),
                cb.data_ptr(), stream()), "group_atomic")
            return pb, cb
        return call

    def probes(name, kern, args):
        """Where the wrapper's time goes: the same call on index maps whose
        lists are runs of consecutive rows (`contiguous`), on 4 of the 24
        samples (`b4`, ~1/6 of the bytes, which fit in L2), and the
        inversion alone on the same maps (`inversion`, this tree only)."""
        if name == "group_scatter":
            idx, grads, n = args
            b, m, _ = idx[0].shape
            runs = [(torch.arange(m * i.shape[-1], device=device) * n
                     // (m * i.shape[-1])).int().reshape(1, m, -1)
                    .expand(b, -1, -1).contiguous() for i in idx]
            out = {"contiguous": lambda: kern(runs, grads, n),
                   "b4": lambda: kern([i[:4] for i in idx],
                                      [g[:4] for g in grads], n)}
            keys, rows = torch.cat([i.reshape(b, -1) for i in idx], 1), n
        else:
            grad, idx, weight, m = args
            b, n_u, _ = idx.shape
            runs = (torch.arange(3 * n_u, device=device) * m // (3 * n_u)
                    ).int().reshape(1, n_u, 3).expand(b, -1, -1).contiguous()
            out = {"contiguous": lambda: kern(grad, runs, weight, m),
                   "b4": lambda: kern(grad[:4], idx[:4], weight[:4], m)}
            keys, rows = idx.reshape(b, -1), m
        try:
            from istnet_tpu_torch.ops import scatter_invert
        except ImportError:
            return out
        out["inversion"] = lambda: scatter_invert.invert_index_cuda(keys, rows)
        return out

    cases = cs.train_kernel_cases(device)
    if hasattr(cs, "with_bf16_scatter_twins"):  # a copy older than them has none
        cases = cs.with_bf16_scatter_twins(cases)
    if "--sweep" in sys.argv[1:]:
        sweep(cases)
        return 0
    sums: dict = {}
    for name in ("group_scatter", "interp_scatter"):
        kern = dispatch.wrapper(name)
        for args, launches in cases[name]:
            grads = args[1] if name == "group_scatter" else [args[0]]
            dtype = str(grads[0].dtype).removeprefix("torch.")
            try:
                kern(*args)
            except TypeError:
                print(f"{name} {cs._label(name, args)}: the wrapper takes no "
                      f"{dtype} cotangent")
                continue
            reads = {"wrapper": lambda: kern(*args),
                     "index_add_": cs.library_call(name, args),
                     "read_flat": read_flat(grads)}
            if name == "group_scatter":
                idx, _, n = args
                rival = group_atomic(idx, grads, n)
                got, want = rival(), plain.group_scatter(*args)
                for g, w in zip(got, want):
                    err = (g - w).abs().max().item()
                    if err > cs.SCATTER_TOL * w.abs().max().item():
                        raise AssertionError(f"group_atomic off plain: {err}")
                reads["group_read_only"] = group_read_only(idx, grads)
                reads["group_atomic"] = rival
            if launches and dtype == "float32":
                reads.update(probes(name, kern, args))
            parts = []
            for what, fn in reads.items():
                by_kernel = cs.device_us(fn)
                us = sum(by_kernel.values()) or float("nan")
                detail = ("" if what != "wrapper" else " (" + ", ".join(
                    f"{k} {v:.1f}" for k, v in sorted(by_kernel.items())) + ")")
                parts.append(f"{what} {us:.1f}{detail}")
                key = (name, dtype, what)
                # the bf16 twins sum as if they took the f32 calls' place
                weight = launches or 1
                sums[key] = sums.get(key, 0.0) + us * weight
            print(f"{name} {cs._label(name, args)} x{launches or 1}: device us "
                  f"a call: " + "; ".join(parts))
    for (name, dtype, what), us in sums.items():
        print(f"step sum {name} {dtype} {what}: {us:.1f} us")
    return 0


if __name__ == "__main__":
    sys.exit(main())
