"""Weight bridge from the JAX package's variables to the port's state dict,
and the loading of checkpoint files.

The port's submodules carry the reference torch key names, so a reference
model-zoo ``.pth`` state dict loads into the port directly
(``load_torch_state_dict``). ``state_dict_from_jax`` maps the
``{"params", "batch_stats"}`` trees of the JAX ``ISTNet`` (resnet18 trunk)
onto those keys: the port's own table of flax paths, written out below, with
the layouts turned back (HWIO conv kernels to OIHW, ``(I, O)`` dense kernels
to ``(O, I[, 1[, 1]])``). Three things have no one-to-one leaf:

- the JAX SharedMLP's dense bias, which torch's bias-free conv lacks, folds
  into the BN running mean (``BN(y + b) == BN'(y)`` with ``mean' = mean -
  b``), exact at eval in float32;
- the trunk's dead ``feats.fc`` weights are zeros;
- a frozen-world-enhancer checkpoint has no
  ``world_enhancer.pose_estimator`` and gets no such keys.

Every leaf of the trees must be used, or the conversion raises.

Under the bf16 policy the fold is one rounding away from JAX on the layers
that run unfused (SA stage 1 and the FP MLPs): JAX rounds ``x @ W + b`` to
bf16 before its BN, the port rounds ``x @ W`` and subtracts the folded mean
in its float32 BN, inside the bf16 tolerance. The fused SA stages fold BN
at call time from these same values (``nn/pointnet2_msg.py::
_fold_shared_mlp``), where ``b - mean`` is the exact negation of the
bridged running mean, as in JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


class ConversionError(ValueError):
    pass


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


_LAYOUT = {
    "vec": lambda a: a,
    "linear": lambda a: a.T,                                   # (I,O)->(O,I)
    "conv1d": lambda a: a.T[:, :, None],                       # ->(O,I,1)
    "conv1x1": lambda a: a.T[:, :, None, None],                # ->(O,I,1,1)
    "conv2d": lambda a: np.transpose(a, (3, 2, 0, 1)),         # HWIO->OIHW
}


class _Bridge:
    """Collects torch keys from flax leaves and accounts for every leaf."""

    def __init__(self, trees: Mapping):
        self.params = _flatten(trees["params"])
        self.stats = _flatten(trees["batch_stats"])
        self.used: set[tuple[str, str]] = set()
        self.out: dict[str, np.ndarray] = {}

    def _take(self, coll: str, path: str) -> np.ndarray:
        leaves = self.params if coll == "params" else self.stats
        if path not in leaves:
            raise ConversionError(f"missing flax leaf: {coll}/{path}")
        self.used.add((coll, path))
        return leaves[path]

    def put(self, key: str, path: str, kind: str) -> None:
        self.out[key] = _LAYOUT[kind](self._take("params", path))

    def bn(self, key: str, path: str, dense_bias: str | None = None) -> None:
        self.put(key + ".weight", path + "/scale", "vec")
        self.put(key + ".bias", path + "/bias", "vec")
        mean = self._take("batch_stats", path + "/mean")
        if dense_bias is not None:
            mean = mean - self._take("params", dense_bias)
        self.out[key + ".running_mean"] = mean
        self.out[key + ".running_var"] = self._take("batch_stats",
                                                    path + "/var")
        self.out[key + ".num_batches_tracked"] = np.zeros((), np.int64)

    def conv(self, key: str, path: str, bias: bool = True) -> None:
        self.put(key + ".weight", path + "/Conv_0/kernel", "conv2d")
        if bias:
            self.put(key + ".bias", path + "/Conv_0/bias", "vec")

    def dense(self, key: str, path: str, kind: str) -> None:
        self.put(key + ".weight", path + "/Dense_0/kernel", kind)
        self.put(key + ".bias", path + "/Dense_0/bias", "vec")

    def leftovers(self) -> list[str]:
        have = ({("params", p) for p in self.params}
                | {("batch_stats", p) for p in self.stats})
        return sorted(f"{c}/{p}" for c, p in have - self.used)


def _encoder(b: _Bridge, name: str) -> None:
    """``ModifiedResnet`` (torch ``<name>.model.*``), resnet18 trunk."""
    t, f = f"{name}.model.", f"{name}/"
    trunk_t, trunk_f = t + "feats.", f + "ResNet18Trunk_0/"
    b.conv(trunk_t + "conv1", trunk_f + "_RConv_0", bias=False)
    b.bn(trunk_t + "bn1", trunk_f + "BatchNorm_0")
    for layer in range(4):
        for sub in range(2):
            bt = f"{trunk_t}layer{layer + 1}.{sub}."
            bf = f"{trunk_f}BasicBlock_{2 * layer + sub}/"
            for ci in range(2):
                b.conv(f"{bt}conv{ci + 1}", f"{bf}_RConv_{ci}", bias=False)
                b.bn(f"{bt}bn{ci + 1}", f"{bf}BatchNorm_{ci}")
            if f"{bf}_RConv_2/Conv_0/kernel" in b.params:
                b.conv(bt + "downsample.0", bf + "_RConv_2", bias=False)
                b.bn(bt + "downsample.1", bf + "BatchNorm_2")
    # the reference trunk's fc is never called; the flax side carries none
    b.out[trunk_t + "fc.weight"] = np.zeros((1000, 512), np.float32)
    b.out[trunk_t + "fc.bias"] = np.zeros((1000,), np.float32)

    for i in range(4):
        b.conv(f"{t}psp.stages.{i}.1", f"{f}PSPModule_0/TorchConv_{i}",
               bias=False)
    b.conv(t + "psp.bottleneck", f + "PSPModule_0/TorchConv_4")
    for i, up in enumerate(("up_1", "up_2")):
        b.conv(f"{t}{up}.conv.1", f"{f}PSPUpsample_{i}/TorchConv_0")
        b.bn(f"{t}{up}.conv.2", f"{f}PSPUpsample_{i}/BatchNorm_0")
        b.put(f"{t}{up}.conv.3.weight", f"{f}PSPUpsample_{i}/PReLU_0/alpha",
              "vec")
    b.conv(t + "up_3.conv.1", f + "up3_conv")
    b.bn(t + "up_3.conv.2", f + "up3_bn")
    b.put(t + "up_3.conv.3.weight", f + "up3_prelu/alpha", "vec")
    b.conv(t + "final.0", f + "final_conv")
    b.bn(t + "final.1", f + "final_bn")
    b.put(t + "final.2.weight", f + "final_prelu/alpha", "vec")


def _shared_mlp(b: _Bridge, key: str, path: str, nlayers: int) -> None:
    for k in range(nlayers):
        dense = f"{path}/TorchDense_{k}/Dense_0"
        b.put(f"{key}.layer{k}.conv.weight", dense + "/kernel", "conv1x1")
        b.bn(f"{key}.layer{k}.normlayer.bn", f"{path}/BatchNorm_{k}",
             dense_bias=dense + "/bias")


def _pointnet2(b: _Bridge, key: str, path: str) -> None:
    for i in range(4):
        for j in range(2):
            _shared_mlp(b, f"{key}.SA_modules.{i}.mlps.{j}",
                        f"{path}/PointnetSAModuleMSG_{i}/SharedMLP_{j}", 3)
    for i in range(4):
        # torch lists the FP modules deepest first, flax in call order
        _shared_mlp(b, f"{key}.FP_modules.{i}.mlp",
                    f"{path}/PointnetFPModule_{3 - i}/SharedMLP_0", 2)


def _seq_mlp(b: _Bridge, key: str, path: str, torch_idx=(0, 2)) -> None:
    for j, i in enumerate(torch_idx):
        b.dense(f"{key}.{i}", f"{path}/TorchDense_{j}", "conv1d")


def _pose_heads(b: _Bridge, key: str, path: str) -> None:
    heads = ("rotation_estimator", "translation_estimator", "size_estimator")
    for h, name in enumerate(heads):
        for j, i in enumerate((0, 2)):
            b.dense(f"{key}.{name}.{i}", f"{path}/MLP_{h}/TorchDense_{j}",
                    "linear")
        b.dense(f"{key}.{name}.4", f"{path}/TorchDense_{h}", "linear")


def _estimator(b: _Bridge, key: str, path: str, mlps) -> None:
    for k, name in enumerate(mlps):
        _seq_mlp(b, f"{key}.{name}", f"{path}/MLP_{k}")
    _pose_heads(b, key, path + "/PoseHeads_0")


_HEAVY = ("pts_mlp1", "pts_mlp2", "pose_mlp1", "pose_mlp2")
_LIGHT = ("pts_mlp", "pose_mlp1", "pose_mlp2")


def state_dict_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` trees of the JAX ``ISTNet``
    (numpy or JAX arrays) -> the port's ``state_dict``, for
    ``load_state_dict(strict=True)``."""
    b = _Bridge(variables)
    _encoder(b, "rgb_cam_extractor")
    _pointnet2(b, "pts_cam_extractor", "pts_cam_extractor")
    t, f = "implicit_transform.feature_refine", \
        "implicit_transform/FeatureDeformer_0"
    _seq_mlp(b, t + ".pts_mlp1", f + "/MLP_0")
    _seq_mlp(b, t + ".deform_mlp1", f + "/MLP_1")
    _seq_mlp(b, t + ".deform_mlp2", f + "/MLP_2", (0, 2, 4))
    _seq_mlp(b, t + ".pred_nocs", f + "/MLP_3")
    b.dense(t + ".pred_nocs.4", f + "/TorchDense_0", "conv1d")
    _estimator(b, "main_estimator", "main_estimator", _HEAVY)
    _estimator(b, "cam_enhancer", "cam_enhancer", _LIGHT)
    _pointnet2(b, "world_enhancer.extractor", "world_enhancer/extractor")
    if "pose_estimator" in variables["params"].get("world_enhancer", {}):
        _estimator(b, "world_enhancer.pose_estimator",
                   "world_enhancer/pose_estimator", _HEAVY)
    left = b.leftovers()
    if left:
        raise ConversionError(
            f"{len(left)} flax leaves not mapped (first 10): {left[:10]}")
    return {k: torch.from_numpy(np.require(v, requirements="C"))
            for k, v in b.out.items()}


def load_npz(path: str) -> dict:
    """The ``params`` / ``batch_stats`` object trees of a converted
    ``.npz`` (as ``istnet_tpu.cli.convert_torch_istnet`` saves them)."""
    data = np.load(path, allow_pickle=True)
    return {"params": data["params"].item(),
            "batch_stats": data["batch_stats"].item()}


def load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    """A ``.pth`` state dict on the CPU, solver containers unwrapped and
    DataParallel prefixes stripped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "model_state_dict", "net"):
            if isinstance(obj.get(key), dict):
                obj = obj[key]
                break
    if not isinstance(obj, dict):
        raise ConversionError(f"unrecognized checkpoint container in {path}")
    return {k.removeprefix("module."): torch.as_tensor(v)
            for k, v in obj.items()}


def load_weights(path: str) -> dict[str, torch.Tensor]:
    """A state dict for ``ISTNet.load_state_dict(strict=True)`` from a
    reference ``.pth`` or from a ``.npz`` of JAX trees."""
    if path.endswith(".npz"):
        return state_dict_from_jax(load_npz(path))
    return load_torch_state_dict(path)
