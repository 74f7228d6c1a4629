#!/usr/bin/env python3
"""Device time of kernel 11 (the depth fill) launch by launch and of kernel 8
(the backward's ball query) SA stage by SA stage, on every path that runs
them:

    python3 tools/depth_fill_query_torch.py

Needs one CUDA card and nvcc. Every call is first checked against its plain
version, then read two ways: by torch.profiler (``chip_smoke.launch_us``,
each launch of a call apart, memsets included; the profiler loses whole
calls' events now and then and reads "lost" there) and by CUDA events around
the replays of a CUDA graph of 10 calls (``graph_us``: no host time between
the launches):

- kernel 11 on the serving frame (``chip_smoke``'s phase 12 frame in
  metres), on one 480 x 640 frame with 35% holes, an empty top band and
  empty columns, and on a batch of 24 such frames (``phase_depth_fill``'s
  inputs); without the bilateral filter equal to the plain version;
- kernel 8 at the SA stages 2-4 of the B=24 train step (camera and world
  radii, ``train_kernel_cases``) and at the lists of the eval grouping (SA
  1-4, B=32) and of the serving bucket of 8 (``kernel_cases``), equal to the
  plain version and to the lists of kernel 2 (the grouping) on the same
  inputs, with kernel 2's whole grouping timed beside it at eval and serve;
- kernel 5 (the fused bf16 SA stages 2-4 of the eval forward, which run
  the same ball query, ``ball_query.cuh``, from device memory), within its
  tolerance of the plain version.

With ``--sweep`` the script instead builds kernels 11 and 8 again for each
entry of ``SWEEP`` (a copy of their sources with constants replaced) and
prints each variant's device us (graph) of kernel 11 at the three inputs
and of kernel 8 a pass of the train and eval paths, every call checked
first.

The package is imported the usual way, this checkout's last: with
``PYTHONPATH`` set to the root of another copy of the repository (say the
previous commit, unpacked with ``git archive``) the script times that
copy's wrappers; the shapes and helpers are always this checkout's
``chip_smoke.py``. The first output lines are the card's name and power
limit and the directory of the package timed; then a line a call, then the
sums over each path.
"""

from __future__ import annotations

import importlib.util
import os
import sys

from three_nn_variants_torch import graph_us, smi

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name -> [(file, old text, new text), ...]: depth_fill.cu's tile heights
# (kTileAH, kTileBH), medians a thread (kRunA, kRunB) and blocks an SM
# (kBlocksA, kBlocksB), and the staged scan's chunks a step (ball_query.cuh)
FILL, QUERY, SCAN = "depth_fill.cu", "ball_query.cu", "ball_query.cuh"
A_RUNS, B_RUNS = "kRunA = 6, kBlocksA = 3", "kRunB = 11, kBlocksB = 2"
SWEEP = {
    "as built": [],
    "A runs 12, 2 blocks": [(FILL, A_RUNS, "kRunA = 12, kBlocksA = 2")],
    "A tiles 40, runs 5": [(FILL, "kTileAH = 48", "kTileAH = 40"),
                           (FILL, A_RUNS, "kRunA = 5, kBlocksA = 3")],
    "B runs 4, 3 blocks": [(FILL, B_RUNS, "kRunB = 4, kBlocksB = 3")],
    "B tiles 48, runs 4, 3 blocks": [(FILL, "kTileBH = 40", "kTileBH = 48"),
                                     (FILL, B_RUNS, "kRunB = 4, kBlocksB = 3")],
    "B tiles 48, runs 13": [(FILL, "kTileBH = 40", "kTileBH = 48"),
                            (FILL, B_RUNS, "kRunB = 13, kBlocksB = 2")],
    "B tiles 32, runs 9": [(FILL, "kTileBH = 40", "kTileBH = 32"),
                           (FILL, B_RUNS, "kRunB = 9, kBlocksB = 2")],
    "scan 1 chunk a step": [(SCAN, "kStagedChunks = 2;", "kStagedChunks = 1;")],
    "scan 4 chunks a step": [(SCAN, "kStagedChunks = 2;", "kStagedChunks = 4;")],
}
SWEEP_SOURCES = ("common.cu", FILL, QUERY, SCAN, "ball_query_group.cu")


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def fill_cases(cs, device) -> list:
    """[(label, depth)]: the serving frame, the 35%-hole frame, B=24."""
    import numpy as np
    import torch
    rng = np.random.RandomState(4)          # as phase_depth_fill draws them
    h, w = cs.FRAME_SHAPE
    one = cs._holey_depth(rng, 1, h, w)
    batch = cs._holey_depth(rng, cs.TRAIN_BATCH, h, w)
    serve = torch.from_numpy(cs._serve_frame(device)[1])[None] / 1000.0
    return [("serving frame", serve.to(device)),
            ("35%-hole frame", torch.from_numpy(one).to(device)),
            (f"B={cs.TRAIN_BATCH}", torch.from_numpy(batch).to(device))]


def time_fill(cs, device) -> None:
    import torch

    from istnet_tpu_torch.ops import depth_fill, dispatch
    kern = dispatch.wrapper("depth_fill")
    for label, depth in fill_cases(cs, device):
        got = kern(depth, 3.0, False)
        if not torch.equal(got, depth_fill.plain(depth, 3.0, False)):
            raise AssertionError(f"depth_fill {label} differs from plain")
        launches = cs.launch_us(lambda: kern(depth))
        total = sum(us for _, us in launches) or float("nan")
        parts = ", ".join(f"{name} {us:.1f}" for name, us in launches)
        print(f"depth_fill {label} {cs._label('depth_fill', (depth,))}: "
              f"device us a call {total:.1f} by launch ({parts or 'lost'}), "
              f"graph {graph_us(lambda: kern(depth)):.1f}")


def query_paths(cs, device) -> dict:
    """path -> [(ball-query args, the grouping's args or None)]."""
    train = cs.train_kernel_cases(device)
    out = {"train": [(args, None) for args, _ in train["ball_query"]]}
    for label, batch in (("eval", 0), ("serve", cs.SERVE_BUCKET)):
        out[label] = [(args[:4], args) for args in
                      cs.kernel_cases(device, batch)["ball_query_group"]]
    return out


def same_lists(grouping_args, idx_list) -> bool:
    """Kernel 2's grouped xyz on these inputs equal to the rows of the
    indices ``idx_list``: the two kernels keep the same lists."""
    import torch

    from istnet_tpu_torch.ops import dispatch
    from istnet_tpu_torch.ops import pointnet2 as plain
    radii, nsamples, xyz, new_xyz = grouping_args[:4]
    grouped = dispatch.wrapper("ball_query_group")(radii, nsamples, xyz,
                                                   new_xyz, None)
    return all(torch.equal(g, plain.group_points(xyz, i)
                           - new_xyz[:, :, None, :])
               for g, i in zip(grouped, idx_list))


def time_query(cs, device) -> None:
    import torch

    from istnet_tpu_torch.ops import dispatch
    from istnet_tpu_torch.ops import pointnet2 as plain
    query = dispatch.wrapper("ball_query")
    group = dispatch.wrapper("ball_query_group")
    for path, cases in query_paths(cs, device).items():
        sums: dict = {}
        for args, grouping in cases:
            got = query(*args)
            if not all(torch.equal(g, w) for g, w in
                       zip(got, plain.ball_query_multi(*args))):
                raise AssertionError(f"ball_query {path} "
                                     f"{cs._label('ball_query', args)} differs")
            if not same_lists(grouping or args, got):
                raise AssertionError(f"ball_query {path}: kernel 2's lists "
                                     f"differ")
            reads = {"kernel 8": lambda: query(*args)}
            if grouping is not None:
                reads["kernel 2 (whole grouping)"] = lambda: group(*grouping)
            parts = []
            for what, fn in reads.items():
                launches = cs.launch_us(fn)
                us = sum(t for _, t in launches) or float("nan")
                g_us = graph_us(fn)
                parts.append(f"{what} {us:.1f}, graph {g_us:.1f}")
                for how, v in (("profiler", us), ("graph", g_us)):
                    sums[(what, how)] = sums.get((what, how), 0.0) + v
            print(f"ball_query {path} {cs._label('ball_query', args)}: device "
                  f"us a call: " + "; ".join(parts))
        for (what, how), us in sums.items():
            print(f"pass sum {path} {what} ({how}): {us:.1f} us")


def time_sa_fused(cs, device) -> None:
    from istnet_tpu_torch.ops import dispatch
    kern = dispatch.wrapper("sa_fused")
    mod = dispatch.KERNELS["sa_fused"]
    total = 0.0
    for args, on_path in cs.kernel_cases_bf16(device)["sa_fused"]:
        if not on_path:
            continue
        cs._check("sa_fused", kern(*args), mod.plain(*args), True)
        launches = cs.launch_us(lambda: kern(*args))
        us = sum(t for _, t in launches) or float("nan")
        total += us
        parts = ", ".join(f"{name} {t:.1f}" for name, t in launches)
        print(f"sa_fused eval bf16 {cs._label('sa_fused', args)}: device us a "
              f"call {us:.1f} ({parts or 'lost'})")
    print(f"pass sum eval bf16 sa_fused (profiler): {total:.1f} us")


def sweep(cs, device) -> None:
    """Each SWEEP variant built into the package's build directory, its
    kernels checked and timed."""
    import torch
    from _sweep_torch import edited_build

    from istnet_tpu_torch.ops import _build, depth_fill, dispatch
    from istnet_tpu_torch.ops import pointnet2 as plain
    fills = fill_cases(cs, device)
    paths = query_paths(cs, device)
    for name, edits in SWEEP.items():
        with edited_build(name, edits, SWEEP_SOURCES):
            fill, query = dispatch.wrapper("depth_fill"), dispatch.wrapper("ball_query")
            try:
                parts = []
                for label, depth in fills:
                    if not torch.equal(fill(depth, 3.0, False),
                                       depth_fill.plain(depth, 3.0, False)):
                        raise AssertionError(f"depth_fill {label} differs")
                    launches = ", ".join(f"{k} {t:.1f}" for k, t in
                                         cs.launch_us(lambda: fill(depth)))
                    parts.append(f"{label} {graph_us(lambda: fill(depth)):.1f} "
                                 f"({launches or 'lost'})")
                for path in ("train", "eval"):
                    total = 0.0
                    for args, grouping in paths[path]:
                        got = query(*args)
                        if not all(torch.equal(g, w) for g, w in
                                   zip(got, plain.ball_query_multi(*args))) \
                                or not same_lists(grouping or args, got):
                            raise AssertionError(f"ball_query {path} differs")
                        total += graph_us(lambda: query(*args))
                    parts.append(f"kernel 8 {path} {total:.1f}")
            except (AssertionError, RuntimeError) as e:
                print(f"sweep {name!r} failed: {e}")
                continue
            regs = [line.strip() for line in
                    _build.build_info.get("log", "").splitlines()
                    if "registers" in line or "spill" in line]
        print(f"sweep {name!r} device us (graph): " + ", ".join(parts))
        for line in regs:
            print(f"  {line}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("depth_fill_query_torch: no CUDA card")
    sys.path.append(REPO)
    cs = load_chip_smoke()
    import istnet_tpu_torch
    print(smi())
    print(f"package {os.path.dirname(istnet_tpu_torch.__file__)}")
    device = torch.device("cuda", 0)
    with cs.policy(torch.float32):
        if "--sweep" in sys.argv[1:]:
            sweep(cs, device)
            return 0
        time_fill(cs, device)
        time_query(cs, device)
    with cs.policy(torch.bfloat16):
        time_sa_fused(cs, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
