"""Inference + evaluation CLI of the port, with the flags of
``istnet_tpu/cli/test.py``.

``python -m istnet_tpu_torch.cli.test --config config/ist_net_default.yaml
  --data_dir data/NOCS --torch_checkpoint ist_net_default.pth
  [--device_preprocess] [--eval_batch 64] [--devices N] [--only_eval]
  [--vis [--vis_axes] [--vis_labels]] [--device cpu]``

Weights come from the port's own checkpoint of ``--test_epoch`` under
``log_dir/ckpt`` (``cli/train.py`` writes it), or from
``--torch_checkpoint``: a reference ``.pth`` state dict loads directly
(strict), a ``.npz`` of JAX trees goes through ``istnet_tpu_torch.convert``.
The model runs on the card unless ``--device cpu`` is given, under the
``compute_dtype`` of the config.

``--devices N`` is data-parallel inference, as the JAX CLI's
(``istnet_tpu/cli/test.py:102-157``): a replica on each of ``cuda:0..N-1``
(N clamped to the cards, with a warning), or N replicas on the CPU with
``--device cpu`` (JAX's virtual CPU devices); it implies batched inference,
even at N = 1, at ``--eval_batch`` (default 64), which must divide by N.

``--vis`` draws the first 50 non-empty frames' boxes after the loop
(``eval/vis.py``) into ``<log_dir>/eval_epoch<E>/vis``.
"""

from __future__ import annotations

import argparse
import os
import time

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
                   help="data-parallel inference over the first N devices "
                        "(instance batch split over replicas); implies "
                        "--eval_batch (default 64), which must divide by N")
    p.add_argument("--vis", action="store_true",
                   help="draw the first 50 frames' boxes into "
                        "<save_path>/vis")
    p.add_argument("--vis_axes", action="store_true",
                   help="axes-arrow box style (vis_utils.py:73-100)")
    p.add_argument("--vis_labels", action="store_true",
                   help="class-name label boxes (vis_utils.py:103-139)")
    p.add_argument("--log_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu'")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

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
        precision.set_compute_dtype(precision.dtype_named(
            cfg.get("compute_dtype", "float32")))

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

        devices, eval_batch = None, args.eval_batch
        if args.devices:
            devices = dp_devices(args.devices, device, logger)
            eval_batch = eval_batch or 64
            if eval_batch % len(devices):
                raise SystemExit(f"--eval_batch {eval_batch} must divide by "
                                 f"the {len(devices)} usable devices")
            logger.info(f"DP inference over {len(devices)} device(s), "
                        f"batch {eval_batch}")
        img_size = int(cfg.test.img_size)
        sample_num = int(cfg.test.sample_num)
        if args.device_preprocess:
            dataset = TestDataset(cfg.test, args.data_dir,
                                  device_preprocess=True)
            if eval_batch:
                logger.info(f"{len(dataset)} test images (device "
                            f"preprocessing, batched x{eval_batch})")
                test_loop.test_func_device_batched(
                    model, dataset, save_path, REAL_INTRINSICS,
                    img_size=img_size, sample_num=sample_num,
                    batch_size=eval_batch, devices=devices)
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
            forward = test_loop.make_forward(model, devices)
            if eval_batch:
                test_loop.test_func_batched(forward, dataset, save_path,
                                            batch_size=eval_batch)
            else:
                test_loop.test_func(forward, dataset, save_path)
        if args.vis:
            draw(dataset, save_path, args.vis_axes, args.vis_labels)

    return evaluate(save_path, logger=logger)


def draw(dataset, save_path: str, axes: bool, labels: bool) -> None:
    """The first 50 frames' predicted (red) and ground-truth (green) boxes
    over the image, from the result pkls the loop wrote, into
    ``<save_path>/vis`` (``istnet_tpu/cli/test.py:168-189``); empty frames
    are skipped."""
    import pickle

    import numpy as np

    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
    from istnet_tpu_torch.eval.vis import draw_detections
    fx, fy, cx, cy = REAL_INTRINSICS
    k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    vis_dir = os.path.join(save_path, "vis")
    for i in range(min(len(dataset), 50)):
        data = dataset[i]
        if data.get("empty"):
            continue
        with open(os.path.join(save_path, os.path.basename(
                dataset.result_pkl_list[i])), "rb") as f:
            result = pickle.load(f)
        draw_detections(data["ori_img"].copy(), vis_dir, "real", i, k,
                        result["pred_RTs"], result["pred_scales"],
                        result["pred_class_ids"], result["gt_RTs"],
                        result["gt_scales"], result["gt_class_ids"],
                        draw_axes=axes, draw_labels=labels)


def dp_devices(n: int, device, logger) -> list:
    """The devices of ``--devices n``: the first n cards (clamped to those
    there are, with the JAX CLI's warning), or n CPU replicas."""
    import torch

    if device.type == "cpu":
        return [device] * n
    cards = torch.cuda.device_count()
    if n > cards:
        logger.warning(f"--devices {n} > available {cards}; using {cards}")
    return [torch.device("cuda", i) for i in range(min(n, cards))]


if __name__ == "__main__":
    main()
