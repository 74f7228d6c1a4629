"""Weight bridge between the JAX package's variables and the port's state
dict, both ways, and the loading of checkpoint files.

The port's submodules carry the reference torch key names, so a reference
model-zoo ``.pth`` state dict loads into the port directly
(``load_torch_state_dict``). ``state_dict_from_jax`` maps the
``{"params", "batch_stats"}`` trees of the JAX ``ISTNet`` or ``PoseNetGT``
(resnet18 trunk), or of a ``ModifiedResnet`` of any trunk, onto those
keys: the port's own table of flax paths, written out below, with the
layouts turned back (HWIO conv kernels to OIHW, ``(I, O)`` dense kernels
to ``(O, I[, 1[, 1]])``). Three things have no one-to-one leaf:

- the JAX SharedMLP's dense bias, which torch's bias-free conv lacks, folds
  into the BN running mean (``BN(y + b) == BN'(y)`` with ``mean' = mean -
  b``), exact at eval in float32;
- the trunk's dead ``feats.fc`` weights are zeros;
- a frozen-world-enhancer checkpoint has no
  ``world_enhancer.pose_estimator`` and gets no such keys.

Every leaf of the trees must be used, or the conversion raises.

The same table runs the other way (``ReverseBridge``,
``trees_from_state_dict``): a reference or port state dict to the
``{"params", "batch_stats"}`` trees that ``istnet_tpu.cli.
convert_torch_istnet`` writes. Each ``_LAYOUT`` kind carries its transform
and the transform's inverse; the SharedMLP dense biases come out as zeros,
``num_batches_tracked`` and the dead ``feats.fc`` are dropped, and every
torch key must be used. One table serves both directions, so they cannot
drift apart.

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

from istnet_tpu_torch.nn.resnet_psp import RESNET_LAYERS, BasicBlock, Bottleneck


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


def _unflatten(flat: Mapping[str, np.ndarray]) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = out
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(v, np.float32)
    return out


# kind: (flax -> torch, torch -> flax)
_LAYOUT = {
    "vec": (lambda a: a, lambda a: a),
    "linear": (lambda a: a.T, lambda a: a.T),                  # (I,O)<->(O,I)
    "conv1d": (lambda a: a.T[:, :, None],                      # <->(O,I,1)
               lambda a: a[:, :, 0].T),
    "conv1x1": (lambda a: a.T[:, :, None, None],               # <->(O,I,1,1)
                lambda a: a[:, :, 0, 0].T),
    "conv2d": (lambda a: np.transpose(a, (3, 2, 0, 1)),        # HWIO<->OIHW
               lambda a: np.transpose(a, (2, 3, 1, 0))),
}


class _Table:
    """The calls the path table makes, shared by both directions."""

    def conv(self, key: str, path: str, bias: bool = True) -> None:
        self.put(key + ".weight", path + "/Conv_0/kernel", "conv2d")
        if bias:
            self.put(key + ".bias", path + "/Conv_0/bias", "vec")

    def dense(self, key: str, path: str, kind: str) -> None:
        self.put(key + ".weight", path + "/Dense_0/kernel", kind)
        self.put(key + ".bias", path + "/Dense_0/bias", "vec")

    def trunk_template(self, trunk_t: str, trunk_f: str) -> None:
        """Before the trunk's entries: nothing to do flax -> torch."""


class Bridge(_Table):
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
        self.out[key] = _LAYOUT[kind][0](self._take("params", path))

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

    def dead(self, key: str, shape: tuple) -> None:
        """A torch key that no flax leaf feeds: zeros."""
        self.out[key] = np.zeros(shape, np.float32)

    def has(self, key_prefix: str, path_prefix: str) -> bool:
        return any(p.startswith(path_prefix) for p in self.params)

    def leftovers(self) -> list[str]:
        have = ({("params", p) for p in self.params}
                | {("batch_stats", p) for p in self.stats})
        return sorted(f"{c}/{p}" for c, p in have - self.used)


class ReverseBridge(_Table):
    """The table run the other way: flax leaves from torch keys, every key
    accounted for. ``params`` and ``stats`` are the flat trees it fills."""

    def __init__(self, state_dict: Mapping):
        self.sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v)) for k, v in state_dict.items()}
        self.used: set[str] = set()
        self.params: dict[str, np.ndarray] = {}
        self.stats: dict[str, np.ndarray] = {}

    def _take(self, key: str) -> np.ndarray:
        if key not in self.sd:
            raise ConversionError(f"missing torch key: {key}")
        self.used.add(key)
        return self.sd[key]

    def put(self, key: str, path: str, kind: str) -> None:
        self.params[path] = _LAYOUT[kind][1](self._take(key))

    def bn(self, key: str, path: str, dense_bias: str | None = None) -> None:
        self.put(key + ".weight", path + "/scale", "vec")
        self.put(key + ".bias", path + "/bias", "vec")
        mean = self._take(key + ".running_mean")
        self.stats[path + "/mean"] = mean
        self.stats[path + "/var"] = self._take(key + ".running_var")
        if dense_bias is not None:
            # torch's SharedMLP conv has no bias: BN absorbs it
            self.params[dense_bias] = np.zeros(mean.shape[0], np.float32)

    def dead(self, key: str, shape: tuple) -> None:
        """A torch key that no flax leaf takes: dropped."""
        if key in self.sd:
            self.used.add(key)

    def has(self, key_prefix: str, path_prefix: str) -> bool:
        return any(k.startswith(key_prefix) for k in self.sd)

    def trunk_template(self, trunk_t: str, trunk_f: str) -> None:
        """The trunk's leaves from ``cli/convert_torch_resnet.py::
        build_flax_trees``, as JAX's converter takes them; the table's
        trunk entries then read the block layout from them and account for
        their keys (writing the same arrays again)."""
        from istnet_tpu_torch.cli.convert_torch_resnet import build_flax_trees
        trunk_sd = {k[len(trunk_t):]: v for k, v in self.sd.items()
                    if k.startswith(trunk_t)
                    and not k.startswith(trunk_t + "fc.")}
        if not trunk_sd:
            raise ConversionError(f"missing torch keys: {trunk_t}*")
        trunk_p, trunk_s = build_flax_trees(trunk_sd)
        self.params.update(_flatten(trunk_p, trunk_f.rstrip("/")))
        self.stats.update(_flatten(trunk_s, trunk_f.rstrip("/")))

    def leftovers(self) -> list[str]:
        return sorted(k for k in set(self.sd) - self.used
                      if not k.endswith("num_batches_tracked"))


def _trunk_layout(b: _Table, trunk_f: str):
    """The block class and stage depths of the flax trunk under
    ``trunk_f``: the factory entry whose block type and block count it
    holds (``BasicBlock_k`` or ``Bottleneck_k``, numbered across stages)."""
    for block in (BasicBlock, Bottleneck):
        kind = f"{trunk_f}{block.__name__}_"
        n = len({p[len(kind):].split("/")[0] for p in b.params
                 if p.startswith(kind)})
        if not n:
            continue
        for depths in (d for blk, d in RESNET_LAYERS.values()
                       if blk is block and sum(d) == n):
            return block, depths
        raise ConversionError(f"{n} {block.__name__} blocks under "
                              f"{trunk_f}: no factory backend has them")
    raise ConversionError(f"no trunk blocks under {trunk_f}")


def trunk(b: _Table, trunk_t: str, trunk_f: str) -> int:
    """The trunk's convs and BNs from the flax ``ResNet18Trunk`` under
    ``trunk_f`` to the torch keys under ``trunk_t``, any factory backend:
    its blocks are ``<Block>_k`` in stage order, each ``_RConv_i`` /
    ``BatchNorm_i`` for its convs and ``_RConv_n`` / ``BatchNorm_n`` (n =
    its conv count) for a downsample
    (``istnet_tpu/cli/convert_torch_resnet.py:35-87``). Returns the width
    of its output."""
    b.trunk_template(trunk_t, trunk_f)
    b.conv(trunk_t + "conv1", trunk_f + "_RConv_0", bias=False)
    b.bn(trunk_t + "bn1", trunk_f + "BatchNorm_0")
    block, depths = _trunk_layout(b, trunk_f)
    n_convs = 3 if block is Bottleneck else 2
    k = 0
    for layer, depth in enumerate(depths):
        for sub in range(depth):
            bt = f"{trunk_t}layer{layer + 1}.{sub}."
            bf = f"{trunk_f}{block.__name__}_{k}/"
            k += 1
            for ci in range(n_convs):
                b.conv(f"{bt}conv{ci + 1}", f"{bf}_RConv_{ci}", bias=False)
                b.bn(f"{bt}bn{ci + 1}", f"{bf}BatchNorm_{ci}")
            if f"{bf}_RConv_{n_convs}/Conv_0/kernel" in b.params:
                b.conv(bt + "downsample.0", f"{bf}_RConv_{n_convs}",
                       bias=False)
                b.bn(bt + "downsample.1", f"{bf}BatchNorm_{n_convs}")
    return 512 * block.expansion


def _encoder(b: _Table, name: str) -> None:
    """``ModifiedResnet`` (torch ``<name>.model.*``; ``name`` empty for an
    encoder on its own), any factory trunk."""
    t, f = (f"{name}.model.", f"{name}/") if name else ("model.", "")
    width = trunk(b, t + "feats.", f + "ResNet18Trunk_0/")
    # the reference trunk's fc is never called; the flax side carries none
    b.dead(t + "feats.fc.weight", (1000, width))
    b.dead(t + "feats.fc.bias", (1000,))

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


def _shared_mlp(b: _Table, key: str, path: str, nlayers: int) -> None:
    for k in range(nlayers):
        dense = f"{path}/TorchDense_{k}/Dense_0"
        b.put(f"{key}.layer{k}.conv.weight", dense + "/kernel", "conv1x1")
        b.bn(f"{key}.layer{k}.normlayer.bn", f"{path}/BatchNorm_{k}",
             dense_bias=dense + "/bias")


def _pointnet2(b: _Table, key: str, path: str) -> None:
    for i in range(4):
        for j in range(2):
            _shared_mlp(b, f"{key}.SA_modules.{i}.mlps.{j}",
                        f"{path}/PointnetSAModuleMSG_{i}/SharedMLP_{j}", 3)
    for i in range(4):
        # torch lists the FP modules deepest first, flax in call order
        _shared_mlp(b, f"{key}.FP_modules.{i}.mlp",
                    f"{path}/PointnetFPModule_{3 - i}/SharedMLP_0", 2)


def _seq_mlp(b: _Table, key: str, path: str, torch_idx=(0, 2)) -> None:
    for j, i in enumerate(torch_idx):
        b.dense(f"{key}.{i}", f"{path}/TorchDense_{j}", "conv1d")


def _pose_heads(b: _Table, key: str, path: str) -> None:
    heads = ("rotation_estimator", "translation_estimator", "size_estimator")
    for h, name in enumerate(heads):
        for j, i in enumerate((0, 2)):
            b.dense(f"{key}.{name}.{i}", f"{path}/MLP_{h}/TorchDense_{j}",
                    "linear")
        b.dense(f"{key}.{name}.4", f"{path}/TorchDense_{h}", "linear")


def _estimator(b: _Table, key: str, path: str, mlps) -> None:
    for k, name in enumerate(mlps):
        _seq_mlp(b, f"{key}.{name}", f"{path}/MLP_{k}")
    _pose_heads(b, key, path + "/PoseHeads_0")


_HEAVY = ("pts_mlp1", "pts_mlp2", "pose_mlp1", "pose_mlp2")
_LIGHT = ("pts_mlp", "pose_mlp1", "pose_mlp2")


def _ist_net(b: _Table) -> None:
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
    # a frozen-world-enhancer checkpoint has no world pose head
    if b.has("world_enhancer.pose_estimator.",
             "world_enhancer/pose_estimator/"):
        _estimator(b, "world_enhancer.pose_estimator",
                   "world_enhancer/pose_estimator", _HEAVY)


def _posenet_gt(b: _Table) -> None:
    _encoder(b, "rgb_extractor")
    _pointnet2(b, "pts_extractor", "pts_extractor")
    _pointnet2(b, "pts_gt_extractor", "pts_gt_extractor")
    _estimator(b, "pose_estimator_aux", "pose_estimator_aux", _HEAVY)


_MODELS = {"ist_net": _ist_net, "posenet_gt": _posenet_gt,
           "modified_resnet": lambda b: _encoder(b, "")}


def state_dict_from_jax(variables: Mapping,
                        model: str = "ist_net") -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` trees of the JAX ``ISTNet``
    (``model="ist_net"``), ``PoseNetGT`` (``"posenet_gt"``) or a
    ``ModifiedResnet`` of any backend on its own (``"modified_resnet"``),
    numpy or JAX arrays -> the port's ``state_dict``, for
    ``load_state_dict(strict=True)``."""
    if model not in _MODELS:
        raise ConversionError(f"unknown model {model!r}")
    b = Bridge(variables)
    _MODELS[model](b)
    left = b.leftovers()
    if left:
        raise ConversionError(
            f"{len(left)} flax leaves not mapped (first 10): {left[:10]}")
    return {k: torch.from_numpy(np.require(v, requirements="C"))
            for k, v in b.out.items()}


def trees_from_state_dict(state_dict: Mapping,
                          model: str = "ist_net") -> dict:
    """A state dict of ``ISTNet`` / ``PoseNetGT`` (reference or port keys,
    tensors or numpy arrays) -> the JAX package's ``{"params",
    "batch_stats"}`` trees, float32 numpy leaves: the inverse of
    ``state_dict_from_jax`` through the same table. Raises
    ``ConversionError`` on a missing or an unmapped torch key."""
    if model not in _MODELS:
        raise ConversionError(f"unknown model {model!r}")
    b = ReverseBridge(state_dict)
    _MODELS[model](b)
    left = b.leftovers()
    if left:
        raise ConversionError(
            f"{len(left)} torch keys not mapped (first 10): {left[:10]}")
    return {"params": _unflatten(b.params),
            "batch_stats": _unflatten(b.stats)}


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


def load_weights(path: str, model: str = "ist_net") -> dict[str, torch.Tensor]:
    """A state dict for ``load_state_dict(strict=True)`` of ``ISTNet``
    (``model="ist_net"``) or ``PoseNetGT`` (``"posenet_gt"``) from a
    reference ``.pth`` or from a ``.npz`` of JAX trees."""
    if path.endswith(".npz"):
        return state_dict_from_jax(load_npz(path), model)
    return load_torch_state_dict(path)
