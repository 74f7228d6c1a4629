"""Training CLI of the port, with the flags of ``istnet_tpu/cli/train.py``.

``python -m istnet_tpu_torch.cli.train --config config/ist_net_default.yaml
  [--data_dir data/NOCS] [--log_dir DIR] [--checkpoint_epoch E]
  [--device cpu]``

Wires config -> model (``model_arch``: ``ist_net`` or ``posenet_gt``) ->
the CAMERA and Real datasets (seeds ``rd_seed`` and ``rd_seed + 1``) ->
their loaders -> ``Solver``, on the card unless ``--device cpu`` is given.
The two-phase recipe's second phase (``freeze_world_enhancer`` with
``world_enhancer_weights``) first moves PoseNetGT's world extractor in;
``--checkpoint_epoch`` resumes from ``log_dir/ckpt/<epoch>``: model,
optimizer and step count, then the next epoch. Checkpoints go to
``log_dir/ckpt`` every 5 epochs.
"""

from __future__ import annotations

import argparse
import os
import time

_NOT_YET = {
    "devices": "--devices (multi-GPU training) is not ported yet: "
               "ROADMAP.md queue 1, item 8",
    "pretrained_backbone": "--pretrained_backbone (ImageNet weights for the "
                           "RGB trunk) is not ported yet: ROADMAP.md queue "
                           "1, item 9",
    "bfloat16": "compute_dtype: bfloat16 in training is not ported yet: "
                "ROADMAP.md queue 1, item 6",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="IST-Net training (PyTorch port)")
    p.add_argument("--config", default="config/ist_net_default.yaml")
    p.add_argument("--data_dir", default="data/NOCS")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel training (not ported yet)")
    p.add_argument("--checkpoint_epoch", type=int, default=-1,
                   help="resume from this epoch's checkpoint (-1: fresh)")
    p.add_argument("--pretrained_backbone", default=None,
                   help="ImageNet weights for the RGB trunk (not ported yet)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def build_model(cfg, train_cfg):
    """The config's model with torch's default initialisation drawn from
    ``rd_seed`` (the trunk's convolutions as the reference draws them),
    fresh BatchNorm statistics."""
    import torch

    from istnet_tpu_torch.entry import init_weights_
    from istnet_tpu_torch.models.ist_net import ISTNet
    from istnet_tpu_torch.models.posenet_gt import PoseNetGT

    sa_npoints = tuple(cfg.get("sa_npoints", (512, 256, 128, 64)))
    if train_cfg.model_arch == "posenet_gt":
        model = PoseNetGT(nclass=cfg.num_category, sa_npoints=sa_npoints)
    else:
        model = ISTNet(nclass=cfg.num_category, sa_npoints=sa_npoints,
                       freeze_world_enhancer=train_cfg.freeze_world_enhancer)
    init_weights_(model, torch.Generator().manual_seed(
        int(cfg.get("rd_seed", 1))))
    return model


def main(argv=None):
    """Train; returns the ``Solver`` (its model, optimizer, step count and
    per-iteration ``records``)."""
    args = parse_args(argv)
    if args.devices:
        raise SystemExit(_NOT_YET["devices"])
    if args.pretrained_backbone:
        raise SystemExit(_NOT_YET["pretrained_backbone"])

    import torch

    from istnet_tpu_torch.data.dataset import TrainingDataset
    from istnet_tpu_torch.data.loader import DataLoader
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.train import checkpoints
    from istnet_tpu_torch.train.solver import Solver
    from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
    from istnet_tpu_torch.utils import Config, get_logger

    cfg = Config.fromfile(args.config)
    if cfg.get("compute_dtype", "float32") == "bfloat16":
        raise SystemExit(_NOT_YET["bfloat16"])
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to train with the "
                         "plain versions on the CPU")
    exp_name = os.path.splitext(os.path.basename(args.config))[0]
    log_dir = args.log_dir or os.path.join("log", exp_name)
    os.makedirs(log_dir, exist_ok=True)
    logger = get_logger(path_file=os.path.join(
        log_dir, f"train_{int(time.time())}.log"))
    logger.info(f"config: {args.config} -> {log_dir} on {device}")

    precision.set_compute_dtype(torch.float32)
    train_cfg = TrainConfig.from_config(cfg)
    model = build_model(cfg, train_cfg)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"#parameters: {n_params / 1e6:.2f}M")

    # two-phase recipe: transplant + freeze the world enhancer
    if train_cfg.freeze_world_enhancer and cfg.get("world_enhancer_weights"):
        checkpoints.load_world_enhancer(
            cfg.world_enhancer_weights, int(cfg.get("world_enhancer_epoch", 30)),
            model)
        logger.info(f"loaded world enhancer from {cfg.world_enhancer_weights}")
    model = model.to(device).train()
    # built before any restore, as the fresh run builds it: the optimizer
    # state maps onto the same parameters in the same order
    optimizer = make_optimizer(model, train_cfg)

    start_epoch, step = 1, 0
    if args.checkpoint_epoch >= 0:
        payload = checkpoints.restore_checkpoint(
            os.path.join(log_dir, "ckpt"), args.checkpoint_epoch, model,
            optimizer)
        start_epoch = int(payload["meta"]["epoch"]) + 1
        step = int(payload["step"])
        logger.info(f"resumed from epoch {args.checkpoint_epoch} (step {step})")

    dl_cfg = cfg.train_dataloader
    iters_per_epoch = train_cfg.iters_per_epoch
    seed0 = int(cfg.get("rd_seed", 1))
    loaders = {}
    for name, data_type, bs, seed in (
            ("syn", "syn", int(dl_cfg.syn_bs), seed0),
            ("real", "real_withLabel", int(dl_cfg.real_bs), seed0 + 1)):
        loaders[name] = DataLoader(
            TrainingDataset(cfg.train_dataset, args.data_dir, data_type=data_type,
                            num_img_per_epoch=iters_per_epoch * bs,
                            use_fill_miss=bool(dl_cfg.use_fill_miss),
                            use_composed_img=bool(dl_cfg.use_composed_img),
                            per_obj=dl_cfg.get("per_obj", ""), seed=seed,
                            device_preprocess=bool(cfg.train_dataset.get(
                                "use_device_preprocess", False))),
            bs, shuffle=bool(dl_cfg.shuffle), drop_last=bool(dl_cfg.drop_last),
            num_workers=int(dl_cfg.num_workers))

    solver = Solver(model, optimizer, train_cfg, cfg,
                    syn_loader=loaders["syn"], real_loader=loaders["real"],
                    logger=logger, log_dir=log_dir, start_epoch=start_epoch,
                    step=step)
    solver.solve()
    return solver


if __name__ == "__main__":
    main()
