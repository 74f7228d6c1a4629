#!/usr/bin/env python3
"""Where the full-width training loop loses to the bare step.

    python3 tools/train_loop_torch.py [--iters 12] [--workers 1,2,4,8]
        [--device-pipeline]
    python3 tools/train_loop_torch.py --host      # no card needed

Needs one CUDA card and nvcc. With ``config/ist_net_default.yaml``'s model
and shapes (B = 18 + 6, N = 1024, 192 x 192) over a synthetic train tree of
8 scenes in a temporary directory, in one process:

1. bare: ``train_step`` on one batch already on the card, as
   ``chip_smoke.py`` phase 10 times it (host clock around ``--iters``
   steps and a synchronise), with the host's time to enqueue a step;
2. cached: the ``Solver``'s epoch over batches loaded beforehand (the
   loop's own work: concatenation, pinned copies, the metric drain);
3. loaders: the ``Solver``'s epoch over ``DataLoader`` s as ``cli/train.py``
   builds them, once for each ``--workers`` count (threads a loader).

For 2 and 3: samples/s over the epoch's iterations after the first (the
first waits for the loaders' first batch), and the medians of ``T_iter``,
``T_data`` and ``T_dispatch`` (``train/solver.py``). The first output
lines are the host's CPU count and the card's name and power limit.

``--device-pipeline`` runs the same three on
``config/ist_net_device_pipeline.yaml``: the loaders yield raw frames and
the step preprocesses and augments them on the card, so the bare step is
``train_step`` with its ``preprocess_fn`` / ``augment_fn`` on one raw batch
already on the card. It adds the raw batch's copy to the card (its bytes,
the host's ms to pin it and enqueue the copy, the ms until it is there) and
the preprocessing's device ms, launches and host enqueue ms a step
(``chip_smoke.device_call``).

``--host`` times the data path alone on the host it runs on, no card
needed: a CAMERA sample of the default config (mean over 24) and a raw
one of the device pipeline's, the OpenCV fill of one frame, a PNG decode,
and a batch of 18 from a ``DataLoader`` of 1 and of 4 threads.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Cached:
    """A loader over batches loaded beforehand, for the Solver."""

    def __init__(self, batches: list[dict]):
        self.batches = batches
        self.batch_size = len(next(iter(batches[0].values())))
        self.dataset = None

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _line(label: str, records: list[dict], batch: int) -> str:
    window = records[1:]
    rate = batch * len(window) / sum(r["T_iter"] for r in window)
    med = {k: statistics.median(r[k] for r in window) * 1e3
           for k in ("T_iter", "T_data", "T_dispatch")}
    return (f"[{label}] {rate:.1f} samples/s over {len(window)} iterations; "
            f"median T_iter {med['T_iter']:.1f} ms, T_data "
            f"{med['T_data']:.1f}, T_dispatch {med['T_dispatch']:.1f}")


def host_times() -> None:
    """The data path's host times (``--host``)."""
    import cv2

    from istnet_tpu_torch.data import depth_utils, synthetic
    from istnet_tpu_torch.data.dataset import TrainingDataset
    from istnet_tpu_torch.data.loader import DataLoader
    from istnet_tpu_torch.utils import Config

    def ms(fn, n: int) -> float:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e3

    cfg = Config.fromfile(os.path.join(REPO, "config", "ist_net_default.yaml"))
    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        synthetic.build_train_trees(data_dir, 8)
        ds = TrainingDataset(cfg.train_dataset, data_dir, data_type="syn",
                             num_img_per_epoch=48, seed=1)
        ds.reset()
        ds[0]
        it = iter(range(24))
        print(f"[host] a sample {ms(lambda: ds[next(it)], 24):.1f} ms")
        raw_cfg = Config.fromfile(os.path.join(
            REPO, "config", "ist_net_device_pipeline.yaml"))
        raw = TrainingDataset(raw_cfg.train_dataset, data_dir,
                              data_type="syn", num_img_per_epoch=48, seed=1,
                              device_preprocess=True)
        raw.reset()
        it = iter(range(24))
        print(f"[host] a raw sample (device pipeline) "
              f"{ms(lambda: raw[next(it)], 24):.1f} ms")
        frame = os.path.join(data_dir, "Real", "train", "scene_1", "0000")
        depth = depth_utils.load_depth(frame)
        print(f"[host] the OpenCV fill of a frame "
              f"{ms(lambda: depth_utils.fill_missing(depth, 1000.0, 1), 10):.1f}"
              f" ms; a colour PNG decode "
              f"{ms(lambda: cv2.imread(frame + '_color.png'), 10):.1f} ms")
        for workers in (1, 4):
            batches = ms(lambda: list(DataLoader(ds, 18, num_workers=workers)), 1)
            print(f"[host] a batch of 18 with {workers} thread(s) "
                  f"{batches / (len(ds) // 18):.1f} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--workers", default="1,2,4,8")
    ap.add_argument("--host", action="store_true",
                    help="time the data path on the host alone")
    ap.add_argument("--device-pipeline", action="store_true",
                    help="config/ist_net_device_pipeline.yaml: raw frames, "
                         "preprocessed and augmented on the card")
    args = ap.parse_args()
    sys.path.append(REPO)
    print(f"os.cpu_count() {os.cpu_count()}")
    if args.host:
        host_times()
        return 0

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("train_loop_torch: needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())

    from istnet_tpu_torch.cli.train import build_model
    from istnet_tpu_torch.data import synthetic
    from istnet_tpu_torch.data.dataset import TrainingDataset
    from istnet_tpu_torch.data.loader import DataLoader
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.train.solver import (
        Solver, concat_batches, device_pipeline, split_batch, to_device)
    from istnet_tpu_torch.train.train_state import (
        TrainConfig, make_optimizer, prepare_batch, train_step)
    from istnet_tpu_torch.utils import Config

    device = torch.device("cuda", 0)
    precision.set_compute_dtype(torch.float32)
    name = ("ist_net_device_pipeline.yaml" if args.device_pipeline
            else "ist_net_default.yaml")
    print(f"config/{name}")
    cfg = Config.fromfile(os.path.join(REPO, "config", name))
    hooks = device_pipeline(cfg, torch.float32)
    raw = hooks[0] is not None
    cfg["max_epoch"] = 1
    cfg["num_mini_batch_per_epoch"] = args.iters
    train_cfg = TrainConfig.from_config(cfg)
    model = build_model(cfg, train_cfg).to(device).train()
    opt = make_optimizer(model, train_cfg)
    dl = cfg.train_dataloader
    sizes = (("syn", int(dl.syn_bs), 1), ("real_withLabel", int(dl.real_bs), 2))
    batch = sum(bs for _, bs, _ in sizes)

    with tempfile.TemporaryDirectory() as root:
        data_dir = os.path.join(root, "data")
        synthetic.build_train_trees(data_dir, 8)

        def loaders(workers: int):
            out = []
            for data_type, bs, seed in sizes:
                ds = TrainingDataset(cfg.train_dataset, data_dir,
                                     data_type=data_type,
                                     num_img_per_epoch=args.iters * bs,
                                     seed=seed, device_preprocess=raw)
                out.append(DataLoader(ds, bs, num_workers=workers))
            return out

        def epoch(syn, real, number: int) -> list[dict]:
            solver = Solver(model, opt, train_cfg, cfg, syn_loader=syn,
                            real_loader=real, step=number * args.iters)
            return solver.train_epoch(number)

        # the cached batches, loaded once
        syn, real = loaders(4)
        syn.dataset.reset()
        real.dataset.reset()
        cached = [list(syn), list(real)]

        gen = torch.Generator(device=device).manual_seed(0)
        merged = concat_batches(cached[0][0], cached[1][0])
        one = to_device(merged if raw else split_batch(merged), device,
                        torch.float32)
        for step in range(2):
            train_step(model, opt, one, step, gen, train_cfg, *hooks)
        torch.cuda.synchronize()
        host = []
        t0 = time.perf_counter()
        for step in range(2, 2 + args.iters):
            t1 = time.perf_counter()
            train_step(model, opt, one, step, gen, train_cfg, *hooks)
            host.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / args.iters
        print(f"[bare] {batch / wall:.1f} samples/s ({wall * 1e3:.1f} ms a "
              f"step); host time to enqueue a step median "
              f"{statistics.median(host):.1f} ms")
        print(_line("cached", epoch(_Cached(cached[0]), _Cached(cached[1]), 1),
                    batch))
        for i, workers in enumerate(int(w) for w in args.workers.split(",")):
            syn, real = loaders(workers)
            print(_line(f"loaders, {workers} threads each",
                        epoch(syn, real, 2 + i), batch))
        if raw:
            # last: no profiler session runs before a timed loop
            from chip_smoke import device_call

            nbytes = sum(a.nbytes for a in merged.values())
            copies = []
            for _ in range(5):
                t1 = time.perf_counter()
                to_device(merged, device, torch.float32)
                t2 = time.perf_counter()
                torch.cuda.synchronize()
                copies.append(((t2 - t1) * 1e3,
                               (time.perf_counter() - t1) * 1e3))
            print(f"[copy] a raw batch of {nbytes / 1e6:.1f} MB: pin and "
                  f"enqueue median "
                  f"{statistics.median(c[0] for c in copies):.1f} ms, on "
                  f"the card after "
                  f"{statistics.median(c[1] for c in copies):.1f} ms")
            us, launches, enqueue = device_call(
                lambda: prepare_batch(one, gen, *hooks))
            print(f"[preprocess] a step's preprocessing and augmentation: "
                  f"device {us / 1e3:.3f} ms in {launches:.0f} launches, "
                  f"host enqueue {enqueue:.3f} ms")

    return 0


if __name__ == "__main__":
    raise SystemExit(main())
