"""Convert an IST-Net / PoseNetGT state dict between a torch ``.pth`` and the
JAX package's ``.npz`` of flax trees, both ways.

    python -m istnet_tpu_torch.cli.convert_torch_istnet \\
        --torch_ckpt ist_net.pth --model ist_net [--out ist_net_tpu.npz]
    python -m istnet_tpu_torch.cli.convert_torch_istnet \\
        --export_npz ist_net_tpu.npz --model ist_net [--out x_torch.pth]

The counterpart of ``istnet_tpu/cli/convert_torch_istnet.py``, with its
flags, its default output names and its files: the ``.npz`` holds the
``params`` / ``batch_stats`` object trees that the JAX package loads, so a
model trained by the port, or a reference model-zoo checkpoint, goes to
the JAX package, and back. Both directions run the one path table of
``istnet_tpu_torch/convert.py`` (``trees_from_state_dict`` forward,
``state_dict_from_jax`` back):

- ``--torch_ckpt``: every torch key must map to a flax leaf
  (``ConversionError`` otherwise); the trunk goes through
  ``cli/convert_torch_resnet.py::build_flax_trees``; the SharedMLP dense
  biases come out as zeros; ``num_batches_tracked`` and the trunk's dead
  ``feats.fc`` are dropped. A frozen-world-enhancer checkpoint, without
  ``world_enhancer.pose_estimator``, gives trees without that head.
- ``--export_npz``: every flax leaf must be used; a nonzero SharedMLP
  dense bias folds into its BN's running mean, ``feats.fc`` and
  ``num_batches_tracked`` come out as zeros.

The port itself loads either file directly (``convert.load_weights``).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from istnet_tpu_torch import convert
from istnet_tpu_torch.convert import ConversionError

__all__ = ["ConversionError", "convert_state_dict", "load_torch_state_dict",
           "convert_file", "save_npz", "load_npz", "export_state_dict",
           "main"]


convert_state_dict = convert.trees_from_state_dict
load_npz = convert.load_npz


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    """A ``.pth`` as numpy arrays, solver containers unwrapped and
    DataParallel prefixes stripped."""
    return {k: v.detach().cpu().numpy()
            for k, v in convert.load_torch_state_dict(path).items()}


def convert_file(torch_ckpt: str, model: str = "ist_net") -> dict:
    return convert_state_dict(load_torch_state_dict(torch_ckpt), model)


def save_npz(trees: dict, path: str) -> None:
    np.savez(path, params=trees["params"], batch_stats=trees["batch_stats"])


def export_state_dict(trees: dict, model: str = "ist_net"
                      ) -> dict[str, np.ndarray]:
    """``{"params", "batch_stats"}`` -> the torch state dict as numpy
    arrays, for ``load_state_dict(strict=True)`` of the reference model or
    the port's."""
    return {k: v.numpy()
            for k, v in convert.state_dict_from_jax(trees, model).items()}


def _count_leaves(tree: dict) -> int:
    return sum(_count_leaves(v) if isinstance(v, dict) else 1
               for v in tree.values())


def main(argv=None) -> str:
    p = argparse.ArgumentParser(
        description="IST-Net / PoseNetGT .pth <-> .npz of flax trees")
    p.add_argument("--torch_ckpt", default=None,
                   help="torch .pth to convert INTO flax trees")
    p.add_argument("--export_npz", default=None,
                   help="converted .npz to export BACK to a torch "
                        "state_dict .pth")
    p.add_argument("--model", default="ist_net",
                   choices=["ist_net", "posenet_gt"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if (args.torch_ckpt is None) == (args.export_npz is None):
        p.error("pass exactly one of --torch_ckpt / --export_npz")
    if args.torch_ckpt:
        trees = convert_file(args.torch_ckpt, args.model)
        out = args.out or args.torch_ckpt.rsplit(".", 1)[0] + "_tpu.npz"
        save_npz(trees, out)
        nleaves = (_count_leaves(trees["params"])
                   + _count_leaves(trees["batch_stats"]))
        print(f"wrote {out} ({nleaves} leaves)")
    else:
        sd = convert.state_dict_from_jax(load_npz(args.export_npz),
                                         args.model)
        out = args.out or args.export_npz.rsplit(".", 1)[0] + "_torch.pth"
        torch.save(sd, out)
        print(f"wrote {out} ({len(sd)} tensors)")
    return out


if __name__ == "__main__":
    main()
