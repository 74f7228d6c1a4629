"""One-command smoke run of the whole two-phase training recipe on a
synthetic NOCS tree (counterpart of ``istnet_tpu/cli/two_phase_smoke.py``):
phase 1 trains ``PoseNetGT``, its ``pts_gt_extractor`` moves into IST-Net's
``world_enhancer.extractor`` and is frozen, phase 2 trains ``ISTNet``, then
``cli/test.py`` restores phase 2's epoch-5 checkpoint and the NOCS mAP
evaluation runs. Every step of the recipe runs through the CLIs, so the
checkpoint format, the transplant, the frozen parameters and the eval
restore are checked as a whole, at tiny shapes.

As in the JAX smoke, phase 1 takes the host input pipeline
(``use_shape_aug``) and phase 2 the device one (``use_device_preprocess``,
``use_device_aug``: raw frames, everything else inside the step).

Usage:
    python -m istnet_tpu_torch.cli.two_phase_smoke [--work_dir DIR]
        [--device cpu]

Prints per-phase progress and ``TWO_PHASE_SMOKE OK`` on success.
"""

from __future__ import annotations

import argparse
import os
import tempfile

COMMON_CFG = """\
sa_npoints: [32, 16, 8, 8]
optimizer: {{name: Adam, lr: 0.01, betas: [0.5, 0.999], eps: 0.000001, weight_decay: 0}}
bn: {{bn_momentum: 0.9, bn_decay: 0.5, decay_step: 4000, bnm_clip: 0.01}}
max_epoch: 5
num_mini_batch_per_epoch: {iters}
num_category: 6
train_dataset:
  img_size: {img}
  sample_num: {pts}
  shift_range: 0.01
{pipeline}  aug_bb_pro: 0.3
  aug_rt_pro: 0.3
  aug_bc_pro: 0.0
  aug_pc_pro: 0.0
  aug_pc_r: 0.002
  aug_nl_pro: 0.0
train_dataloader:
  syn_bs: 2
  real_bs: 2
  num_workers: 1
  shuffle: True
  drop_last: True
  use_fill_miss: True
  use_composed_img: True
  per_obj: ''
test:
  img_size: {img}
  sample_num: {pts}
  test_path:
rd_seed: 1
per_write: 1
compute_dtype: float32
"""

HOST_PIPELINE = """\
  use_shape_aug: True
  use_device_aug: False
"""
DEVICE_PIPELINE = """\
  use_shape_aug: False
  use_device_aug: True
  use_device_preprocess: True
"""

PHASE1_CFG = """\
model_arch: posenet_gt
loss: {{}}
""" + COMMON_CFG

PHASE2_CFG = """\
model_arch: ist_net
freeze_world_enhancer: True
world_enhancer_weights: {we_ckpt}
world_enhancer_epoch: 5
loss: {{gamma1: 1.0, gamma2: 100}}
""" + COMMON_CFG


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--work_dir", default=None,
                   help="where data/configs/logs go (default: a temp dir)")
    p.add_argument("--img_size", type=int, default=48)
    p.add_argument("--sample_num", type=int, default=128)
    p.add_argument("--iters", type=int, default=2, help="iters per epoch")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)

    from istnet_tpu_torch.cli import test as cli_test
    from istnet_tpu_torch.cli import train as cli_train
    from istnet_tpu_torch.data.synthetic import build_test_tree, build_train_trees

    work = args.work_dir or tempfile.mkdtemp(prefix="two_phase_smoke_")
    data_dir = os.path.join(work, "data")
    os.makedirs(data_dir, exist_ok=True)

    print(f"[two-phase] work dir: {work}", flush=True)
    print("[two-phase] generating synthetic NOCS trees ...", flush=True)
    build_train_trees(data_dir)
    build_test_tree(data_dir)

    fmt = dict(img=args.img_size, pts=args.sample_num, iters=args.iters)
    p1_cfg = os.path.join(work, "posenet_gt_smoke.yaml")
    with open(p1_cfg, "w") as f:
        f.write(PHASE1_CFG.format(pipeline=HOST_PIPELINE, **fmt))
    p1_log = os.path.join(work, "log_posenet_gt")
    device = ["--device", args.device]

    print("[two-phase] phase 1: PoseNetGT training ...", flush=True)
    cli_train.main(["--config", p1_cfg, "--data_dir", data_dir,
                    "--log_dir", p1_log] + device)
    we_ckpt = os.path.join(p1_log, "ckpt")
    if not os.path.isdir(we_ckpt):
        raise RuntimeError("phase-1 checkpoint missing")

    p2_cfg = os.path.join(work, "ist_net_freeze_smoke.yaml")
    with open(p2_cfg, "w") as f:
        f.write(PHASE2_CFG.format(we_ckpt=we_ckpt, pipeline=DEVICE_PIPELINE,
                                  **fmt))
    p2_log = os.path.join(work, "log_ist_net_freeze")

    print("[two-phase] phase 2: IST-Net training (world enhancer "
          "transplanted + frozen; device input pipeline) ...", flush=True)
    cli_train.main(["--config", p2_cfg, "--data_dir", data_dir,
                    "--log_dir", p2_log] + device)

    print("[two-phase] inference + NOCS mAP evaluation ...", flush=True)
    cli_test.main(["--config", p2_cfg, "--data_dir", data_dir,
                   "--log_dir", p2_log, "--test_epoch", "5"] + device)

    eval_dir = os.path.join(p2_log, "eval_epoch5")
    pkls = [f for f in os.listdir(eval_dir) if f.endswith(".pkl")]
    if not pkls:
        raise RuntimeError("no result pkls written")
    print(f"[two-phase] {len(pkls)} result pkls in {eval_dir}", flush=True)
    print("TWO_PHASE_SMOKE OK", flush=True)


if __name__ == "__main__":
    main()
