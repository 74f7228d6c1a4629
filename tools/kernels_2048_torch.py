#!/usr/bin/env python3
"""Device time of the kernels whose shapes N = 2048 points change, beside
their N = 1024 shapes:

    python3 tools/kernels_2048_torch.py

Needs one CUDA card and nvcc. For the B=24 bf16 train step
(``chip_smoke.train_kernel_cases(points=..., bf16=True)``) and the B=32
eval forward (``chip_smoke.kernel_cases(points=...)``), at N = 1024 and
N = 2048: kernel 1 (FPS) and kernel 2 (the grouping) at SA 1 of the
camera extractor, kernel 3 (the FP interpolation), kernel 10 (the
backward's 3-NN with the weights) and the interpolation scatter at FP 1.
Each call is checked against its plain version first
(``chip_smoke._check``); then its device us a call by CUDA events around
the replays of a CUDA graph of 10 calls (``three_nn_variants_torch.
graph_us``: no host time between the launches), its us a call by events
over eager launches (the host's launch time included where it outruns the
card) and its bound (``chip_smoke.bound_ms``, the larger of bytes and
operations). The first lines are the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

# (path, kernel, index of the case in its list): SA 1 / FP 1 of the camera
# extractor (the train cases list the camera stages first, FP 1 last of
# the four; the eval cases list the SA stages in order, FP 1 last)
PICKS = (("fps", 0), ("ball_query_group", 0), ("fp_interpolate", 3),
         ("three_nn", 3), ("interp_scatter", 3))


def main() -> int:
    import torch

    import chip_smoke as cs
    from istnet_tpu_torch.ops import dispatch
    from three_nn_variants_torch import graph_us
    if not torch.cuda.is_available():
        raise SystemExit("kernels_2048_torch: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cs.phase_build()
    dev = torch.device("cuda", 0)
    for points in (1024, 2048):
        with cs.policy(torch.bfloat16):
            train = cs.train_kernel_cases(dev, points=points, bf16=True)
        evals = cs.kernel_cases(dev, points=points)
        paths = (("train bf16 B=24", {k: [a for a, _ in v]
                                      for k, v in train.items()}),
                 ("eval f32 B=32", evals))
        for path, cases in paths:
            for name, i in PICKS:
                if name not in cases:
                    continue
                args = cases[name][i]
                kern = dispatch.wrapper(name)
                plain = dispatch.KERNELS[name].plain
                with cs.policy(torch.bfloat16 if "bf16" in path
                               else torch.float32):
                    got, want = kern(*args), plain(*args)
                    torch.cuda.synchronize()
                    weights = name == "three_nn" and args[2:] and args[2]
                    cs._check(name + " weights" if weights else name, got,
                              want, "bf16" in path)
                    g_us = graph_us(lambda: kern(*args))
                    e_us = cs.cuda_ms(lambda: kern(*args), iters=20) * 1e3
                    by, op = cs.bound_ms(name, args, got)
                print(f"[{path} N={points}] {name} {cs._label(name, args)}: "
                      f"device {g_us:.1f} us a call (graph), events "
                      f"{e_us:.1f} us, bound {max(by, op) * 1e3:.2f} us "
                      f"({'bytes' if by >= op else 'operations'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
