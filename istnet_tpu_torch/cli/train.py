"""Training CLI of the port, with the flags of ``istnet_tpu/cli/train.py``.

``python -m istnet_tpu_torch.cli.train --config config/ist_net_default.yaml
  [--data_dir data/NOCS] [--log_dir DIR] [--checkpoint_epoch E]
  [--pretrained_backbone trunk.npz] [--devices N] [--device cpu]``

Wires config -> model (``model_arch``: ``ist_net`` or ``posenet_gt``) ->
the CAMERA and Real datasets (seeds ``rd_seed`` and ``rd_seed + 1``; raw
frames under ``use_device_preprocess``) -> their loaders -> ``Solver``, on
the card unless ``--device cpu`` is given, under the config's
``compute_dtype`` (float32, or bfloat16 as ``config/ist_net_2048pt_dp.yaml``
trains). ``--pretrained_backbone`` starts the RGB trunk from ImageNet
weights (a ``.npz`` of ``cli/convert_torch_resnet.py``).
The two-phase recipe's second phase (``freeze_world_enhancer`` with
``world_enhancer_weights``) first moves PoseNetGT's world extractor in;
``--checkpoint_epoch`` resumes from ``log_dir/ckpt/<epoch>``: model,
optimizer and step count, then the next epoch. Checkpoints go to
``log_dir/ckpt`` every 5 epochs.

Data parallel, one process a device (the JAX CLI's mesh):

- launched by torchrun (``torchrun --nproc_per_node N -m
  istnet_tpu_torch.cli.train ...``; its variables set), each process joins
  the group (NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``);
- otherwise ``--devices N`` (N > 1) spawns N such processes over a
  rendezvous on 127.0.0.1: ``cuda:0..N-1``, N clamped to the cards with a
  warning, or N CPU processes under gloo with ``--device cpu``; ``main``
  returns rank 0's records (``DataParallelRun``). ``--devices 1`` is the
  single-process run.

The config's batch sizes are global: every rank loads ``syn_bs / N`` and
``real_bs / N`` rows, its datasets seeded ``rd_seed + rank * 7919`` and
``+ 1`` (``istnet_tpu/cli/train.py:175-196``); each rank writes its own log
file, suffixed ``_p<rank>``.

FSDP (``parallel: {fsdp: N [, dp: M]}``, N > 1; ``--devices`` or torchrun
as above) runs in the JAX CLI's order (``istnet_tpu/cli/train.py:
130-151``): the whole model is built, takes the ImageNet trunk and the
world-enhancer transplant and goes to the device; then
``parallel.mesh.shard_state_fsdp`` over ``make_mesh_2d(dp, fsdp)``, then
the optimizer on the sharded parameters, then ``--checkpoint_epoch``'s
sharded restore (each rank its own shards), then the Solver. Checkpoints
are sharded (``train/checkpoints.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import logging
import os
import sys
import time

# the RGB encoder whose trunk --pretrained_backbone fills, by model_arch
ENCODERS = {"ist_net": "rgb_cam_extractor", "posenet_gt": "rgb_extractor"}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="IST-Net training (PyTorch port)")
    p.add_argument("--config", default="config/ist_net_default.yaml")
    p.add_argument("--data_dir", default="data/NOCS")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel training over N processes, one a "
                        "device (default: 1; ignored under torchrun)")
    p.add_argument("--checkpoint_epoch", type=int, default=-1,
                   help="resume from this epoch's checkpoint (-1: fresh)")
    p.add_argument("--pretrained_backbone", default=None,
                   help="ImageNet weights for the RGB trunk: a .npz of "
                        "cli/convert_torch_resnet.py (either framework's)")
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


@dataclasses.dataclass
class DataParallelRun:
    """What ``main`` returns in the process that spawned the ranks: rank
    0's per-iteration records and step count, and each rank's
    ``state_digest`` of its trained model (all equal)."""

    records: list
    step: int
    digests: list


def state_digest(model) -> str:
    """SHA-256 of a model's state, or of a state dict (every tensor's
    bytes, in key order)."""
    import torch
    from torch.distributed.tensor import DTensor

    h = hashlib.sha256()
    state = model if isinstance(model, dict) else model.state_dict()
    for key, t in state.items():
        if isinstance(t, DTensor):     # an FSDP shard: every rank gathers
            t = t.full_tensor()
        h.update(key.encode())
        h.update(t.detach().cpu().contiguous().view(-1).view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def main(argv=None):
    """Train; returns the ``Solver`` (its model, optimizer, step count and
    per-iteration ``records``), or a ``DataParallelRun`` where ``--devices
    N`` spawned the ranks."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)

    import torch

    from istnet_tpu_torch.parallel import multihost
    if multihost.launch_env() is None and (args.devices or 1) > 1:
        n = args.devices
        if args.device != "cpu":
            cards = torch.cuda.device_count()
            if cards == 0:
                raise SystemExit("no CUDA card: pass --device cpu to train "
                                 "with the plain versions on the CPU")
            if n > cards:
                logging.getLogger("istnet").warning(
                    f"--devices {n} > available {cards}; using {cards}")
                n = cards
        if n > 1:
            return _spawn(argv, n, args.device)
    owned = not torch.distributed.is_initialized()
    device = multihost.initialize(args.device)
    try:
        return train(args, device)
    finally:
        if owned:
            multihost.shutdown()


def _spawn(argv, n: int, device: str) -> DataParallelRun:
    from istnet_tpu_torch.parallel import multihost
    if device != "cpu":
        from istnet_tpu_torch.ops import _build
        _build.build()       # once here, not in every rank at once
    results = multihost.spawn(_rank_main, n, argv)
    digests = [r["digest"] for r in results]
    if len(set(digests)) != 1:
        raise RuntimeError(f"the ranks' trained models differ: {digests}")
    return DataParallelRun(results[0]["records"], results[0]["step"], digests)


def _rank_main(rank: int, world: int, store, argv) -> dict:
    import torch

    from istnet_tpu_torch.parallel import multihost
    from istnet_tpu_torch.parallel.mesh import unwrap
    args = parse_args(argv)
    if args.device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    device = multihost.initialize(args.device, store=store, rank=rank,
                                  world_size=world)
    try:
        solver = train(args, device)
        return {"records": solver.records, "step": solver.step,
                "digest": state_digest(unwrap(solver.model))}
    finally:
        multihost.shutdown()


def train(args, device):
    """The run of one process (of the group, where there is one) on
    ``device``; returns its ``Solver``."""
    import torch

    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.parallel import multihost
    from istnet_tpu_torch.parallel.mesh import make_mesh_2d, shard_state_fsdp
    from istnet_tpu_torch.train import checkpoints
    from istnet_tpu_torch.train.solver import Solver, fsdp_mesh_shape
    from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
    from istnet_tpu_torch.utils import Config, get_logger

    cfg = Config.fromfile(args.config)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card: pass --device cpu to train with the "
                         "plain versions on the CPU")
    n_proc, rank = multihost.process_count(), multihost.process_index()
    exp_name = os.path.splitext(os.path.basename(args.config))[0]
    log_dir = args.log_dir or os.path.join("log", exp_name)
    os.makedirs(log_dir, exist_ok=True)
    suffix = f"_p{rank}" if n_proc > 1 else ""
    logger = get_logger(path_file=os.path.join(
        log_dir, f"train_{int(time.time())}{suffix}.log"))
    logger.info(f"config: {args.config} -> {log_dir} on {device}"
                + (f" (process {rank}/{n_proc})" if n_proc > 1 else ""))

    # the config's policy (istnet_tpu/cli/train.py:111-113); the parameters
    # and Adam's state stay float32 under both
    precision.set_compute_dtype(precision.dtype_named(
        cfg.get("compute_dtype", "float32")))
    train_cfg = TrainConfig.from_config(cfg)
    model = build_model(cfg, train_cfg)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"#parameters: {n_params / 1e6:.2f}M")

    # before the transplant, the sharding, the optimizer and DDP's first
    # broadcast (istnet_tpu/cli/train.py:123-129)
    if args.pretrained_backbone:
        from istnet_tpu_torch.cli.convert_torch_resnet import (
            load_pretrained_backbone)
        load_pretrained_backbone(model, args.pretrained_backbone,
                                 ENCODERS[train_cfg.model_arch])
        logger.info(f"loaded ImageNet backbone from {args.pretrained_backbone}")

    # two-phase recipe: transplant + freeze the world enhancer
    if train_cfg.freeze_world_enhancer and cfg.get("world_enhancer_weights"):
        checkpoints.load_world_enhancer(
            cfg.world_enhancer_weights, int(cfg.get("world_enhancer_epoch", 30)),
            model)
        logger.info(f"loaded world enhancer from {cfg.world_enhancer_weights}")
    model = model.to(device).train()
    dl = cfg.train_dataloader
    mesh_shape = fsdp_mesh_shape(cfg.get("parallel"), n_proc,
                                 int(dl.syn_bs) + int(dl.real_bs))
    if mesh_shape is not None:
        model = shard_state_fsdp(make_mesh_2d(*mesh_shape, device.type),
                                 model)
    # built after the sharding and before any restore, as the fresh run
    # builds it: the optimizer state maps onto the same parameters in the
    # same order
    optimizer = make_optimizer(model, train_cfg)

    start_epoch, step = 1, 0
    ckpt_dir = os.path.join(log_dir, "ckpt")
    if args.checkpoint_epoch >= 0 and mesh_shape is not None:
        step, meta = checkpoints.restore_checkpoint_sharded(
            ckpt_dir, args.checkpoint_epoch, model, optimizer)
        start_epoch = int(meta["epoch"]) + 1
        logger.info(f"resumed from epoch {args.checkpoint_epoch} "
                    "(sharded restore)")
    elif args.checkpoint_epoch >= 0:
        payload = checkpoints.restore_checkpoint(
            ckpt_dir, args.checkpoint_epoch, model, optimizer)
        start_epoch = int(payload["meta"]["epoch"]) + 1
        step = int(payload["step"])
        logger.info(f"resumed from epoch {args.checkpoint_epoch} (step {step})")

    if (cfg.train_dataset.get("use_device_aug", False)
            and cfg.train_dataset.get("use_shape_aug", False)):
        logger.warning("both use_device_aug and use_shape_aug enabled — "
                       "samples would be augmented twice; disable one")
    loaders = build_loaders(cfg, args.data_dir, train_cfg.iters_per_epoch,
                            rank, n_proc)
    solver = Solver(model, optimizer, train_cfg, cfg,
                    syn_loader=loaders["syn"], real_loader=loaders["real"],
                    logger=logger, log_dir=log_dir, start_epoch=start_epoch,
                    step=step)
    solver.solve()
    return solver


def build_loaders(cfg, data_dir: str, iters_per_epoch: int, rank: int = 0,
                  world: int = 1) -> dict:
    """Rank ``rank``'s syn and real loaders of ``world``: its share of the
    config's global batch sizes, datasets seeded ``rd_seed + rank * 7919``
    and ``+ 1`` (``RANK_SEED_STRIDE``)."""
    from istnet_tpu_torch.data.dataset import TrainingDataset
    from istnet_tpu_torch.data.loader import DataLoader
    from istnet_tpu_torch.parallel.multihost import per_host_batch_size
    from istnet_tpu_torch.train.solver import RANK_SEED_STRIDE

    dl_cfg = cfg.train_dataloader
    seed0 = int(cfg.get("rd_seed", 1)) + rank * RANK_SEED_STRIDE
    loaders = {}
    for name, data_type, bs, seed in (
            ("syn", "syn", per_host_batch_size(int(dl_cfg.syn_bs), world),
             seed0),
            ("real", "real_withLabel",
             per_host_batch_size(int(dl_cfg.real_bs), world), seed0 + 1)):
        loaders[name] = DataLoader(
            TrainingDataset(cfg.train_dataset, data_dir, data_type=data_type,
                            num_img_per_epoch=iters_per_epoch * bs,
                            use_fill_miss=bool(dl_cfg.use_fill_miss),
                            use_composed_img=bool(dl_cfg.use_composed_img),
                            per_obj=dl_cfg.get("per_obj", ""), seed=seed,
                            device_preprocess=bool(cfg.train_dataset.get(
                                "use_device_preprocess", False))),
            bs, shuffle=bool(dl_cfg.shuffle), drop_last=bool(dl_cfg.drop_last),
            num_workers=int(dl_cfg.num_workers))
    return loaders


if __name__ == "__main__":
    main()
