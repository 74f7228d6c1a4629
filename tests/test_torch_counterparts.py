"""Every public name of the JAX package has its counterpart in the port.

The test walks ``istnet_tpu/`` by AST and takes each module's public
top-level ``def`` and ``class``. Each must either stand under the same
name in the port's mirror module (``istnet_tpu/x/y.py`` ->
``istnet_tpu_torch.x.y``), or have an entry in ``COUNTERPARTS``: the
counterpart (``module:attribute`` or a source file of the repo) and a
line on why the name differs. A JAX name added without either fails here
by name; an entry that no longer resolves, or that a same-named
counterpart has made needless, fails too.
"""

import ast
import importlib
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX_PKG = REPO / "istnet_tpu"

_BQG = "istnet_tpu_torch/csrc/ball_query_group.cu"
_GROUPING_MXU = ("a Mosaic device for an exact gather through bf16 MXU "
                 "one-hot dots; the CUDA grouping reads float32 rows")

# (JAX module, name): (counterpart, reason)
COUNTERPARTS = {
    ("cli/convert_torch_resnet.py", "load_into_params"): (
        "istnet_tpu_torch.cli.convert_torch_resnet:load_pretrained_backbone",
        "writes the trunk into a torch model instead of flax trees"),
    ("cli/train.py", "init_variables"): (
        "istnet_tpu_torch.cli.train:build_model",
        "a torch module carries its own variables"),
    ("data/device_preprocess.py", "fill_in_multiscale_tpu"): (
        "istnet_tpu_torch.ops:fill_in_multiscale",
        "the device fill: kernel 11 on the card, its plain version here"),
    ("data/device_preprocess.py", "fill_missing_tpu"): (
        "istnet_tpu_torch.data.device_preprocess:fill_missing",
        "the _tpu suffix dropped"),
    ("data/device_preprocess.py", "preprocess_instances_tpu"): (
        "istnet_tpu_torch.data.device_preprocess:preprocess_instances",
        "the _tpu suffix dropped"),
    ("data/device_preprocess.py", "preprocess_shared_image_tpu"): (
        "istnet_tpu_torch.data.device_preprocess:preprocess_shared_image",
        "the _tpu suffix dropped"),
    ("data/device_preprocess.py", "preprocess_train_instances_tpu"): (
        "istnet_tpu_torch.data.device_preprocess:preprocess_train_instances",
        "the _tpu suffix dropped"),
    ("nn/layers.py", "TorchConv"): (
        "torch.nn:Conv2d", "torch's own layer, as in the reference"),
    ("nn/layers.py", "TorchDense"): (
        "torch.nn:Linear",
        "torch's own Linear / Conv1d / 1x1 Conv2d, as in the reference"),
    ("nn/resnet_psp.py", "ResNet18Trunk"): (
        "istnet_tpu_torch.nn.resnet_psp:ResNetTrunk",
        "one trunk class for every factory backend"),
    ("ops/ball_query_pallas.py", "ball_query_group"): (
        "istnet_tpu_torch.ops:ball_query_group",
        "the differentiable grouping: kernel 2 forward, kernel 8 and the "
        "grouping scatter backward on the card"),
    ("ops/ball_query_pallas.py", "ball_query_group_pallas"): (
        "istnet_tpu_torch.ops.ball_query_group:ball_query_group_cuda",
        "TPU kernel 9 -> csrc/ball_query_group.cu"),
    ("ops/ball_query_pallas.py", "ball_query_group_pallas_t"): (
        "istnet_tpu_torch.ops.ball_query_group:ball_query_group_cuda",
        "TPU kernel 2 -> csrc/ball_query_group.cu"),
    ("ops/ball_query_pallas.py", "ball_query_multi_pallas"): (
        "istnet_tpu_torch.ops.ball_query:ball_query_multi_cuda",
        "TPU kernel 8 -> csrc/ball_query.cu"),
    ("ops/ball_query_pallas.py", "ball_query_pallas"): (
        "istnet_tpu_torch.ops.pointnet2:ball_query",
        "the single-radius query; the card's queries run in kernel 8 or "
        "fused into the grouping"),
    ("ops/ball_query_pallas.py", "block_phase"): (_BQG, _GROUPING_MXU),
    ("ops/ball_query_pallas.py", "bp_indicator"): (_BQG, _GROUPING_MXU),
    ("ops/ball_query_pallas.py", "split_exact"): (_BQG, _GROUPING_MXU),
    ("ops/ball_query_pallas.py", "split_exact_t"): (_BQG, _GROUPING_MXU),
    ("ops/ball_query_pallas.py", "recombine_exact"): (_BQG, _GROUPING_MXU),
    ("ops/ball_query_pallas.py", "recombine_exact_t"): (_BQG, _GROUPING_MXU),
    ("ops/ball_query_pallas.py", "bqg_tile"): (
        _BQG, "the TPU kernel's VMEM centroid tile; the CUDA kernel's "
        "block shape is a compile-time constant"),
    ("ops/ball_query_pallas.py", "lane_cumsum"): (
        "istnet_tpu_torch/csrc/ball_query.cuh",
        "hit ranks by a prefix sum over lanes (Mosaic has no cumsum); CUDA "
        "ranks them with a warp ballot and popc"),
    ("ops/ball_query_pallas.py", "sublane_cumsum"): (
        "istnet_tpu_torch/csrc/ball_query.cuh",
        "as lane_cumsum, over sublanes"),
    ("ops/ball_query_pallas.py", "make_tri"): (
        "istnet_tpu_torch/csrc/ball_query.cuh",
        "the MXU prefix sum's triangular matrix; CUDA ranks by ballot"),
    ("ops/ball_query_pallas.py", "make_tri_lower"): (
        "istnet_tpu_torch/csrc/ball_query.cuh",
        "the MXU prefix sum's triangular matrix; CUDA ranks by ballot"),
    ("ops/depth_fill_pallas.py", "fill_in_multiscale_pallas"): (
        "istnet_tpu_torch.ops.depth_fill:fill_in_multiscale_cuda",
        "TPU kernel 11 -> csrc/depth_fill.cu"),
    ("ops/dispatch.py", "ball_query"): (
        "istnet_tpu_torch.ops.pointnet2:ball_query",
        "the port's forward never queries without grouping; the backward's "
        "query is kernel 8"),
    ("ops/dispatch.py", "ball_query_multi"): (
        "istnet_tpu_torch.ops.ball_query:ball_query_multi_cuda",
        "kernel 8, called by the grouping's backward"),
    ("ops/dispatch.py", "fold_upsample_kernel_ok"): (
        "istnet_tpu_torch.ops.dispatch:fold_upsample_conv",
        "the CUDA fold takes every CUDA tensor: nothing to ask up front"),
    ("ops/dispatch.py", "three_interpolate"): (
        "istnet_tpu_torch.ops.pointnet2:three_interpolate",
        "on the card the interpolation runs fused in kernel 3 "
        "(ops.fp_interpolate)"),
    ("ops/dispatch.py", "three_nn"): (
        "istnet_tpu_torch.ops.three_nn:three_nn_cuda",
        "kernel 10, called by the FP interpolation's backward"),
    ("ops/fold_upsample_pallas.py", "fold_upsample_conv_pallas"): (
        "istnet_tpu_torch.ops.fold_upsample:fold_upsample_conv_cuda",
        "TPU kernel 4 -> csrc/fold_upsample.cu"),
    ("ops/fps_pallas.py", "furthest_point_sample_pallas"): (
        "istnet_tpu_torch.ops.fps:furthest_point_sample_cuda",
        "TPU kernel 1 -> csrc/fps.cu"),
    ("ops/golden.py", "ball_query_golden"): (
        "istnet_tpu_torch.ops.pointnet2:ball_query",
        "the plain versions are the port's golden references"),
    ("ops/golden.py", "fps_golden"): (
        "istnet_tpu_torch.ops.pointnet2:furthest_point_sample",
        "the plain versions are the port's golden references"),
    ("ops/golden.py", "three_nn_golden"): (
        "istnet_tpu_torch.ops.pointnet2:three_nn",
        "the plain versions are the port's golden references"),
    ("ops/pointnet2.py", "three_interpolate_mm"): (
        "istnet_tpu_torch.ops.pointnet2:three_interpolate",
        "an MXU one-hot contraction is a TPU formulation; a gather here"),
    ("ops/sa_fused_pallas.py", "sa_msg_fused_pallas"): (
        "istnet_tpu_torch.ops.sa_fused:sa_msg_fused_cuda",
        "TPU kernels 5-6 -> csrc/sa_fused.cu"),
    ("ops/sa_fused_pallas.py", "sa_msg_fused_t_l1_pallas"): (
        "istnet_tpu_torch.ops.sa_fused:sa_msg_fused_cuda",
        "TPU kernel 7 (stage 1's layout) -> the same CUDA kernel"),
    ("ops/sa_fused_pallas.py", "sa_tile"): (
        "istnet_tpu_torch/csrc/sa_fused.cu",
        "the TPU kernel's VMEM centroid tile; the CUDA kernel's block "
        "shape is a compile-time constant"),
    ("ops/three_nn_pallas.py", "fp_interpolate"): (
        "istnet_tpu_torch.ops:fp_interpolate",
        "the differentiable FP interpolation: kernel 3 forward, kernel 10 "
        "and the interpolation scatter backward on the card"),
    ("ops/three_nn_pallas.py", "fp_interpolate_pallas"): (
        "istnet_tpu_torch.ops.fp_interpolate:fp_interpolate_cuda",
        "TPU kernel 3 -> csrc/fp_interpolate.cu"),
    ("ops/three_nn_pallas.py", "three_nn_pallas"): (
        "istnet_tpu_torch.ops.three_nn:three_nn_cuda",
        "TPU kernel 10 -> csrc/three_nn.cu"),
    ("parallel/mesh.py", "batch_sharding"): (
        "istnet_tpu_torch.parallel.mesh:shard_batch",
        "a rank takes its rows; no sharding object"),
    ("parallel/mesh.py", "replicated"): (
        "istnet_tpu_torch.parallel.mesh:replicate",
        "a copy a device; no sharding object"),
    ("parallel/mesh.py", "make_mesh"): (
        "istnet_tpu_torch.parallel.mesh:make_mesh_2d",
        "a torch DeviceMesh over (dp, fsdp)"),
    ("parallel/mesh.py", "jit_eval_forward_dp"): (
        "istnet_tpu_torch.parallel.mesh:eval_forward_dp",
        "eager replicas, no jit"),
    ("parallel/mesh.py", "jit_train_step_dp"): (
        "istnet_tpu_torch.parallel.mesh:wrap_dp",
        "DDP around the model; train_state.train_step steps it"),
    ("parallel/mesh.py", "jit_train_step_fsdp"): (
        "istnet_tpu_torch.parallel.mesh:shard_state_fsdp",
        "FSDP2's fully_shard; train_state.train_step steps it"),
    ("parallel/multihost.py", "global_batch"): (
        "istnet_tpu_torch.parallel.mesh:shard_batch",
        "under DDP each rank keeps its own rows; no global array"),
    ("train/train_state.py", "TrainState"): (
        "torch.optim:Adam",
        "the state is the module (parameters, BN buffers) and its "
        "optimizer"),
    ("train/train_state.py", "create_train_state"): (
        "istnet_tpu_torch.train.train_state:make_optimizer",
        "the module holds the parameters; the optimizer is the rest"),
    ("train/train_state.py", "ema_batch_stats"): (
        "istnet_tpu_torch.train.train_state:update_bn_stats",
        "in place on the BN buffers"),
    ("train/train_state.py", "make_train_step"): (
        "istnet_tpu_torch.train.train_state:train_step",
        "an eager step, no jit factory"),
}


def _public_names(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), str(path))
    return [n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef))
            and not n.name.startswith("_")]


JAX_MODULES = {str(p.relative_to(JAX_PKG)): _public_names(p)
               for p in sorted(JAX_PKG.rglob("*.py"))}
JAX_MODULES = {rel: names for rel, names in JAX_MODULES.items() if names}


def _mirror(rel: str):
    """The port's module at the JAX module's place, or None."""
    dotted = rel[:-len(".py")].replace("/", ".").removesuffix(".__init__")
    name = "istnet_tpu_torch" + ("." + dotted if dotted != "__init__" else "")
    if not (REPO / "istnet_tpu_torch" / rel).is_file():
        return None
    return importlib.import_module(name)


def _resolve(target: str) -> bool:
    if ":" not in target:
        return (REPO / target).is_file()
    module, attr = target.split(":")
    obj = importlib.import_module(module)
    for part in attr.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_the_walk_sees_the_jax_package():
    assert len(JAX_MODULES) > 40
    assert "fill_missing" in JAX_MODULES["data/depth_utils.py"]


@pytest.mark.parametrize("rel", sorted(JAX_MODULES))
def test_every_public_name_has_a_counterpart(rel):
    mirror = _mirror(rel)
    missing = [name for name in JAX_MODULES[rel]
               if not (mirror is not None and hasattr(mirror, name))
               and (rel, name) not in COUNTERPARTS]
    assert not missing, (
        f"istnet_tpu/{rel}: {missing} have no counterpart in "
        f"istnet_tpu_torch/{rel} and no entry in COUNTERPARTS")


def test_every_entry_resolves_and_is_needed():
    stale, broken = [], []
    for (rel, name), (target, reason) in COUNTERPARTS.items():
        assert reason, (rel, name)
        if name not in JAX_MODULES.get(rel, []):
            stale.append((rel, name, "no such JAX name"))
            continue
        mirror = _mirror(rel)
        if mirror is not None and hasattr(mirror, name):
            stale.append((rel, name, "a same-named counterpart exists"))
        if not _resolve(target):
            broken.append((rel, name, target))
    assert not stale, stale
    assert not broken, broken
