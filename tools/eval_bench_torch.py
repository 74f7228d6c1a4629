#!/usr/bin/env python3
"""REAL275-scale eval-loop run of ``istnet_tpu_torch`` on one CUDA card,
the counterpart of ``tools/eval_bench.py``: images/s over 2,754 images.

    python3 tools/eval_bench_torch.py [--images 2754]
        [--mode batched|device|device_batched|all] [--eval_batch 64]

No NOCS data ships with the repository, so the run writes a test set of
REAL275's image count (``data/synthetic.py::build_real275_scale_tree``:
one segmentation pkl per image, every image's PNGs symlinked to one
synthetic scene of 2 instances, so that the host loads and decodes each
image as a real run does) in a temporary directory and times, under the
bf16 policy with the seeded full-width model of ``entry.build_serving_model``:

- ``batched``: ``eval/test_loop.py::test_func_batched`` (host
  preprocessing, cross-image instance batches of ``--eval_batch``);
- ``device``: ``test_func_device`` (raw frames to the card; the fill on
  kernel 11, crop and sampling there);
- ``device_batched``: ``test_func_device_batched`` (the device pipeline
  with cross-image batches of ``--eval_batch``).

Each mode's time runs from its first image to its last result pkl on the
host clock (the loops end in a synchronising read); the kernels are built
and the model warmed by one forward before. Prints one JSON line with
``tools/eval_bench.py``'s keys (``images``, ``<mode>_images_per_sec``,
``<mode>_total_s``) and the card's name and power limit.

``--device cpu`` rehearses the script at small shapes (48x48 crops, 128
points, SA npoints 32/16/8/8, the kernels' plain versions; tier-1 runs it):
no device time. Without a card and without ``--device cpu`` it exits
non-zero. Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

MODES = ("batched", "device", "device_batched")
# the CPU rehearsal's shapes: (img_size, sample_num, SA npoints)
CPU_SHAPES = (48, 128, (32, 16, 8, 8))


def run(modes=MODES, images: int = 2754, eval_batch: int = 64,
        device="cuda", work: str | None = None) -> dict:
    """Time ``modes`` over a tree of ``images`` images under ``work`` (a
    temporary directory, removed after, when None): ``tools/eval_bench.py``'s
    keys. The compute policy is restored after."""
    import torch

    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS, TestDataset
    from istnet_tpu_torch.data.synthetic import build_real275_scale_tree
    from istnet_tpu_torch.entry import SA_NPOINTS, build_serving_model
    from istnet_tpu_torch.eval import test_loop
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.ops import _build
    from istnet_tpu_torch.utils import Config

    on_card = torch.device(device).type == "cuda"
    img, points, sa = (192, 1024, SA_NPOINTS) if on_card else CPU_SHAPES
    own = work is None
    work = work or tempfile.mkdtemp(prefix="eval_bench_torch_")
    old = precision.compute_dtype()
    try:
        data_dir = os.path.join(work, "data")
        t0 = time.perf_counter()
        build_real275_scale_tree(data_dir, images)
        print(f"built the {images}-image tree under {work} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        if on_card:
            _build.library()
        model = build_serving_model(torch.bfloat16, device, sa_npoints=sa)
        forward = test_loop.make_forward(model)
        # cuDNN and cuBLAS handles, the model's packed weights
        forward(_warm_inputs(eval_batch, points, img))
        cfg = Config({"img_size": img, "sample_num": points})
        results = {"images": images}
        loops = {
            "batched": lambda ds, save: test_loop.test_func_batched(
                forward, ds, save, batch_size=eval_batch, progress=False,
                prefetch_workers=4),
            "device": lambda ds, save: test_loop.test_func_device(
                test_loop.make_device_forward(model, REAL_INTRINSICS,
                                              img_size=img,
                                              sample_num=points),
                ds, save, progress=False),
            "device_batched": lambda ds, save:
                test_loop.test_func_device_batched(
                    model, ds, save, REAL_INTRINSICS, img_size=img,
                    sample_num=points, batch_size=eval_batch,
                    progress=False),
        }
        for mode in modes:
            ds = TestDataset(cfg, data_dir,
                             device_preprocess=mode != "batched")
            save = os.path.join(work, "res_" + mode)
            t0 = time.perf_counter()
            loops[mode](ds, save)
            dt = time.perf_counter() - t0
            n = len(os.listdir(save))
            if n != images:
                raise AssertionError(f"{mode}: {n} result pkls of {images}")
            results[f"{mode}_images_per_sec"] = n / dt
            results[f"{mode}_total_s"] = dt
            print(f"{mode}: {n} images in {dt:.1f} s ({n / dt:.2f} img/s)",
                  flush=True)
        return results
    finally:
        precision.set_compute_dtype(old)
        if own:
            shutil.rmtree(work, ignore_errors=True)


def _warm_inputs(b: int, points: int, img: int) -> dict:
    import numpy as np
    rng = np.random.RandomState(0)
    return {"rgb": rng.rand(b, img, img, 3).astype(np.float32),
            "pts": (rng.randn(b, points, 3) * 0.1).astype(np.float32),
            "choose": rng.randint(0, img * img, (b, points)).astype(np.int32),
            "category_label": np.zeros(b, np.int32)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--images", type=int, default=2754)  # REAL275's test set
    p.add_argument("--mode", default="batched", choices=(*MODES, "all"))
    p.add_argument("--eval_batch", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p.add_argument("--keep", action="store_true",
                   help="keep the tree (its directory is printed)")
    args = p.parse_args(argv)

    import torch
    on_card = torch.device(args.device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("eval_bench_torch: needs a CUDA card (--device cpu "
                         "rehearses at small shapes)")
    modes = MODES if args.mode == "all" else (args.mode,)
    work = tempfile.mkdtemp(prefix="eval_bench_torch_") if args.keep else None
    results = run(modes, args.images, args.eval_batch, args.device, work)
    if on_card:
        from bench_torch import card_name_and_limit
        results["device"] = card_name_and_limit()
    else:
        results["device"] = "cpu (rehearsal, no device time)"
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    sys.exit(main())
