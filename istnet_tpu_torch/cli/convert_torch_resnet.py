"""ImageNet weights for the RGB trunk: a torchvision-layout ResNet ``.pth``
to the ``.npz`` of flax trees that ``istnet_tpu/cli/convert_torch_resnet.py``
writes, and that ``.npz`` into a port model's trunk.

    python -m istnet_tpu_torch.cli.convert_torch_resnet \\
        --torch_ckpt resnet18-5c106cde.pth --out resnet18_imagenet.npz

then ``cli/train.py --pretrained_backbone resnet18_imagenet.npz``. The
``.npz`` holds the same keys and arrays as JAX's converter writes, so the
files of the two frameworks are interchangeable. Every factory backend
converts (resnet18/34 BasicBlock, resnet50/101/152 Bottleneck; the block
type and the stage depths are read from the keys). The weights are
stride-independent, so the reference's stride-8 trunk takes torchvision's
as they are. Nothing is downloaded: the ``.pth`` is a local file, read
with ``torch.load`` (torchvision is not needed).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from istnet_tpu_torch.convert import Bridge, ConversionError, trunk

_STAGES = ("layer1", "layer2", "layer3", "layer4")
TRUNK = "ResNet18Trunk_0"


def torch_sd_to_numpy(torch_ckpt_path: str) -> dict:
    """A torchvision ResNet state dict as numpy arrays, its classifier
    (``fc.*``) left out."""
    sd = torch.load(torch_ckpt_path, map_location="cpu", weights_only=True)
    return {k: v.numpy() for k, v in sd.items() if "fc." not in k}


def build_flax_trees(np_sd: dict) -> tuple[dict, dict]:
    """torchvision ResNet state dict -> ``(params, batch_stats)`` of the
    flax ``ResNet18Trunk``: the trunk's ``_RConv_0`` / ``BatchNorm_0``,
    then ``<Block>_k`` numbered across the stages, each with ``_RConv_i``
    / ``BatchNorm_i`` for its convs and ``_RConv_n`` / ``BatchNorm_n`` (n
    = its conv count) for a downsample. Conv kernels go OIHW -> HWIO; a
    BN's weight and bias are ``scale`` / ``bias`` params, its running
    statistics ``mean`` / ``var``."""

    def conv(name):
        return {"kernel": np.transpose(np_sd[name + ".weight"], (2, 3, 1, 0))}

    def bn(name):
        p = {"scale": np_sd[name + ".weight"], "bias": np_sd[name + ".bias"]}
        s = {"mean": np_sd[name + ".running_mean"],
             "var": np_sd[name + ".running_var"]}
        return p, s

    bottleneck = "layer1.0.conv3.weight" in np_sd
    n_convs = 3 if bottleneck else 2
    block_name = "Bottleneck" if bottleneck else "BasicBlock"
    trunk_p = {"_RConv_0": {"Conv_0": conv("conv1")}}
    trunk_p["BatchNorm_0"], bn0_s = bn("bn1")
    trunk_s = {"BatchNorm_0": bn0_s}
    blk = 0
    for lname in _STAGES:
        n_blocks = 1 + max(int(k.split(".")[1]) for k in np_sd
                           if k.startswith(lname + "."))
        for sub in range(n_blocks):
            prefix = f"{lname}.{sub}"
            p: dict = {}
            s: dict = {}
            names = [(f"{prefix}.conv{ci + 1}", f"{prefix}.bn{ci + 1}")
                     for ci in range(n_convs)]
            if prefix + ".downsample.0.weight" in np_sd:
                names.append((prefix + ".downsample.0",
                              prefix + ".downsample.1"))
            for ci, (conv_name, bn_name) in enumerate(names):
                p[f"_RConv_{ci}"] = {"Conv_0": conv(conv_name)}
                p[f"BatchNorm_{ci}"], s[f"BatchNorm_{ci}"] = bn(bn_name)
            trunk_p[f"{block_name}_{blk}"] = p
            trunk_s[f"{block_name}_{blk}"] = s
            blk += 1
    return trunk_p, trunk_s


def load_npz_trunk(npz_path: str) -> tuple[dict, dict]:
    """The ``(params, batch_stats)`` trunk trees of a converted ``.npz``."""
    with np.load(npz_path, allow_pickle=True) as data:
        return data["params"].item(), data["batch_stats"].item()


@torch.no_grad()
def load_pretrained_backbone(model: torch.nn.Module, npz_path: str,
                             encoder: str = "rgb_cam_extractor") -> list[str]:
    """Write a converted trunk into ``<encoder>.model.feats.*`` of
    ``model`` (``rgb_cam_extractor`` of ``ISTNet``, ``rgb_extractor`` of
    ``PoseNetGT``; ``encoder=""`` where ``model`` is a ``ModifiedResnet``
    itself), in place: every conv and every BN of the trunk, the
    running statistics included (``num_batches_tracked`` to 0), and no
    other key; the dead classifier ``fc`` keeps its values. The
    counterpart of JAX's ``load_into_params``
    (``istnet_tpu/cli/convert_torch_resnet.py:90-122``). Raises
    ``ConversionError`` unless the file fills every trunk key at its shape
    and every leaf of the file is used. Returns the keys written."""
    trunk_p, trunk_s = load_npz_trunk(npz_path)
    bridge = Bridge({"params": {TRUNK: trunk_p},
                     "batch_stats": {TRUNK: trunk_s}})
    prefix = f"{encoder}.model.feats." if encoder else "model.feats."
    trunk(bridge, prefix, TRUNK + "/")
    left = bridge.leftovers()
    if left:
        raise ConversionError(f"{len(left)} leaves of {npz_path} not "
                              f"mapped (first 10): {left[:10]}")
    state = model.state_dict()
    want = {k for k in state
            if k.startswith(prefix) and not k.startswith(prefix + "fc.")}
    got = set(bridge.out)
    if got != want:
        raise ConversionError(
            f"{npz_path} does not fit {prefix}*: missing "
            f"{sorted(want - got)[:10]}, unknown {sorted(got - want)[:10]}")
    for k, v in bridge.out.items():
        if tuple(state[k].shape) != v.shape:
            raise ConversionError(f"{k}: {v.shape} in {npz_path}, "
                                  f"{tuple(state[k].shape)} in the model")
    for k, v in bridge.out.items():
        state[k].copy_(torch.from_numpy(np.array(v)))
    return sorted(got)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="torchvision ResNet .pth -> trunk .npz")
    p.add_argument("--torch_ckpt", required=True)
    p.add_argument("--out", default="resnet18_imagenet.npz")
    args = p.parse_args(argv)
    trunk_p, trunk_s = build_flax_trees(torch_sd_to_numpy(args.torch_ckpt))
    np.savez(args.out, params=trunk_p, batch_stats=trunk_s)
    print(f"wrote {args.out}")
    return args.out


if __name__ == "__main__":
    main()
