"""Inference + evaluation CLI of the port, with the flags of
``istnet_tpu/cli/test.py``.

``python -m istnet_tpu_torch.cli.test --config config/ist_net_default.yaml
  --data_dir data/NOCS --torch_checkpoint ist_net_default.pth
  [--device_preprocess] [--eval_batch 64] [--only_eval] [--device cpu]``

Weights come from the port's own checkpoint of ``--test_epoch`` under
``log_dir/ckpt`` (``cli/train.py`` writes it), or from
``--torch_checkpoint``: a reference ``.pth`` state dict loads directly
(strict), a ``.npz`` of JAX trees goes through ``istnet_tpu_torch.convert``.
The model runs on the card unless ``--device cpu`` is given, under the
``compute_dtype`` of the config.
"""

from __future__ import annotations

import argparse
import os
import time

_NOT_YET = {
    "devices": "--devices (multi-GPU inference) is not ported yet: "
               "ROADMAP.md queue 1, item 8",
    "vis": "--vis (eval/vis.py) is not ported yet: ROADMAP.md queue 1, "
           "item 9",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="IST-Net testing (PyTorch port)")
    p.add_argument("--config", default="config/ist_net_default.yaml")
    p.add_argument("--data_dir", default="data/NOCS")
    p.add_argument("--test_epoch", type=int, default=30)
    p.add_argument("--only_eval", action="store_true",
                   help="skip inference, evaluate existing result pkls")
    p.add_argument("--mask_label", action="store_true",
                   help="surface parity with the reference test.py, which "
                        "parses but never reads this flag")
    p.add_argument("--torch_checkpoint", default=None,
                   help="a reference-trained torch .pth state dict, or a "
                        ".npz of JAX trees (converted on the fly), instead "
                        "of the port's checkpoint under log_dir/ckpt")
    p.add_argument("--device_preprocess", action="store_true",
                   help="run depth completion/crop/sampling/resize on the "
                        "device, in front of the model forward")
    p.add_argument("--eval_batch", type=int, default=None,
                   help="cross-image batched inference at this fixed "
                        "instance batch instead of per-image buckets")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel inference (not ported yet)")
    p.add_argument("--vis", action="store_true",
                   help="draw detection boxes (not ported yet)")
    p.add_argument("--vis_axes", action="store_true")
    p.add_argument("--vis_labels", action="store_true")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.devices:
        raise SystemExit(_NOT_YET["devices"])
    if args.vis or args.vis_axes or args.vis_labels:
        raise SystemExit(_NOT_YET["vis"])

    import torch

    from istnet_tpu_torch import convert
    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS, TestDataset
    from istnet_tpu_torch.eval import test_loop
    from istnet_tpu_torch.eval.nocs_map import evaluate
    from istnet_tpu_torch.models.ist_net import ISTNet
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.train import checkpoints
    from istnet_tpu_torch.utils import Config, get_logger

    cfg = Config.fromfile(args.config)
    exp_name = os.path.splitext(os.path.basename(args.config))[0]
    log_dir = args.log_dir or os.path.join("log", exp_name)
    ckpt_dir = os.path.join(log_dir, "ckpt")
    if not (args.only_eval or args.torch_checkpoint or os.path.exists(
            checkpoints.checkpoint_path(ckpt_dir, args.test_epoch))):
        raise SystemExit(f"no checkpoint of epoch {args.test_epoch} under "
                         f"{ckpt_dir}: train with cli/train.py, or pass "
                         "--torch_checkpoint")
    save_path = os.path.join(log_dir, f"eval_epoch{args.test_epoch}")
    os.makedirs(save_path, exist_ok=True)
    logger = get_logger(
        path_file=os.path.join(log_dir, f"test_{int(time.time())}.log"))

    if not args.only_eval:
        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit("no CUDA card: pass --device cpu to run the "
                             "plain versions on the CPU")
        dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[
            cfg.get("compute_dtype", "float32")]
        precision.set_compute_dtype(dtype)

        model = ISTNet(
            nclass=cfg.num_category,
            freeze_world_enhancer=bool(cfg.get("freeze_world_enhancer", False)),
            sa_npoints=tuple(cfg.get("sa_npoints", (512, 256, 128, 64))))
        if args.torch_checkpoint:
            source = args.torch_checkpoint
            state = convert.load_weights(source)
        else:
            source = f"{ckpt_dir} epoch {args.test_epoch}"
            state = checkpoints.restore_for_eval(ckpt_dir,
                                                 args.test_epoch)["model"]
        if model.freeze_world_enhancer:
            # a frozen checkpoint carries no world pose head; eval never
            # calls it, so the module's own initial values stay
            own = model.state_dict()
            state = {**{k: v for k, v in own.items()
                        if k.startswith("world_enhancer.pose_estimator.")},
                     **state}
        model.load_state_dict(state, strict=True)
        model = model.eval().to(device)
        logger.info(f"loaded {source} on {device}")

        img_size = int(cfg.test.img_size)
        sample_num = int(cfg.test.sample_num)
        if args.device_preprocess:
            dataset = TestDataset(cfg.test, args.data_dir,
                                  device_preprocess=True)
            if args.eval_batch:
                logger.info(f"{len(dataset)} test images (device "
                            f"preprocessing, batched x{args.eval_batch})")
                test_loop.test_func_device_batched(
                    model, dataset, save_path, REAL_INTRINSICS,
                    img_size=img_size, sample_num=sample_num,
                    batch_size=args.eval_batch)
            else:
                logger.info(f"{len(dataset)} test images (device "
                            f"preprocessing)")
                dfwd = test_loop.make_device_forward(
                    model, REAL_INTRINSICS, img_size=img_size,
                    sample_num=sample_num)
                test_loop.test_func_device(dfwd, dataset, save_path)
        else:
            dataset = TestDataset(cfg.test, args.data_dir)
            logger.info(f"{len(dataset)} test images")
            forward = test_loop.make_forward(model)
            if args.eval_batch:
                test_loop.test_func_batched(forward, dataset, save_path,
                                            batch_size=args.eval_batch)
            else:
                test_loop.test_func(forward, dataset, save_path)

    return evaluate(save_path, logger=logger)


if __name__ == "__main__":
    main()
