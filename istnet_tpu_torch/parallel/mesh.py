"""Data parallelism of the train step and of the eval forward (counterpart
of ``istnet_tpu/parallel/mesh.py``).

The JAX package jits its step over a 1-D device mesh: the batch sharded on
its leading axis (``P(DATA_AXIS)``), parameters replicated, the gradient
``psum`` inserted by GSPMD, BatchNorm statistics global. Here one process
runs each device (``parallel/multihost.py``):

- ``wrap_dp`` gives the model's BatchNorms the process group (global-batch
  statistics, ``nn/layers.py::BatchNorm``) and wraps it in
  ``DistributedDataParallel``, which averages the gradients. Each rank's
  loss is its rows' mean, so the average is the global batch's gradient.
- ``shard_batch`` cuts a rank's contiguous rows out of a global batch.
- ``eval_forward_dp`` is ``jit_eval_forward_dp``: one process, one
  replica a device, an instance batch's rows split over them, as the
  reference's ``DataParallel`` eval wrap (``test.py:91-92``).

FSDP (ZeRO-3) over a 2-D ``(dp, fsdp)`` mesh, JAX's ``make_mesh_2d`` /
``jit_train_step_fsdp``, is FSDP2's ``fully_shard`` over a ``DeviceMesh``:

- ``make_mesh_2d`` names the axes ``("dp", "fsdp")``; rank ``r`` sits at
  ``(r // fsdp, r % fsdp)``, the row-major order of JAX's
  ``P((DATA_AXIS, FSDP_AXIS))``, so ``shard_batch_2d`` is ``shard_batch``
  over the flattened mesh. Parameters are replicated over ``dp`` and
  sharded over ``fsdp`` (hybrid sharding); each rank's loss is its rows'
  mean and FSDP2 averages the gradients over the whole mesh, as DDP does.
- ``fsdp_shardings`` places each parameter by JAX's rule
  (``_fsdp_leaf_spec``): the largest axis, in JAX's layout of the weight,
  that ``fsdp`` divides, ties to the earliest. FSDP2 cannot keep a
  parameter replicated inside a unit: the leaves JAX replicates (under
  ``FSDP_MIN_SIZE`` elements, or with no axis that ``fsdp`` divides) are
  sharded on dim 0 here, padded where ``fsdp`` does not divide it.
  Replicating them through ``ignored_params`` would leave their gradients
  unreduced. The Adam moments take their parameter's placement; the
  BatchNorm buffers stay whole on every rank (JAX's replicated
  ``batch_stats``).
- ``shard_state_fsdp`` gives every BatchNorm the whole world's statistics
  (the batch is split over both axes) and applies ``fully_shard`` with
  ``reshard_after_forward=True`` (GSPMD gathers each weight where it is
  used) to each unit of ``fsdp_units``, then to the root. A unit is a
  module whose ``forward`` is called: outside it, its parameters are
  shards (``DTensor``), so no unit is a layer whose weight a parent reads
  in its own code (``nn/layers.py::conv2d_nhwc`` / ``pointwise``, the
  encoder's up_3 and final head, the SharedMLPs' folds). The units:

  - the RGB encoder: each trunk stage (``layer1``..``layer4``), the trunk
    (its stem and the unused classifier), PSP, ``up_1``, ``up_2``, then
    the encoder itself (``up_3`` and ``final``, whose weights its own
    ``forward`` reads);
  - every SA and FP stage of each ``PointNet2MSG``;
  - each head: ``implicit_transform``, ``main_estimator``,
    ``cam_enhancer`` (IST-Net), ``pose_estimator_aux`` (PoseNetGT);
  - IST-Net's ``world_enhancer.pose_estimator``, then ``world_enhancer``
    itself, so that the frozen recipe's parameters, which get no
    gradient, stay out of the trainable units' reduce-scatters;
  - the root, which keeps nothing but what no unit holds.

  No ``MixedPrecisionPolicy``: the compute policy (``nn/precision.py``)
  casts inside the modules under bf16, and the parameters, gradients and
  Adam state stay float32, as in JAX. The optimizer is built after
  ``shard_state_fsdp``, on the sharded parameters.
"""

from __future__ import annotations

import contextlib
import copy

import math

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from istnet_tpu_torch.nn.layers import BatchNorm
from istnet_tpu_torch.nn.pointnet2_msg import PointNet2MSG
from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet

DATA_AXIS = "dp"
FSDP_AXIS = "fsdp"
FSDP_MIN_SIZE = 2 ** 11
# a weight's torch dims in the order of JAX's axes (``convert.py``'s
# layouts): Linear (O, I) and Conv1d (O, I, 1) from (I, O), Conv2d OIHW
# from HWIO; a 1x1 Conv2d from a Dense (I, O) keeps that order too, its
# unit axes never being chosen
JAX_AXIS_ORDER = {1: (0,), 2: (1, 0), 3: (1, 0, 2), 4: (2, 3, 1, 0)}


def set_batch_norm_group(model: torch.nn.Module, group) -> int:
    """Every BatchNorm of ``model`` takes its statistics over ``group``
    (None: this process's rows only); returns how many were set."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    for bn in bns:
        bn.group = group
    return len(bns)


def wrap_dp(model: torch.nn.Module, group=None) -> DistributedDataParallel:
    """``model`` (on this process's device) with global-batch BatchNorm
    over ``group`` (the default group if None), in
    ``DistributedDataParallel``:

    - ``broadcast_buffers=False``: the running statistics are equal on
      every rank by construction (the EMA of global statistics);
    - ``gradient_as_bucket_view=True``: the gradients are views of the
      all-reduce buckets, no second copy of the ~26M float32 gradients;
    - ``static_graph=True``: every recipe leaves parameters without a
      gradient (the RGB trunk's classifier, kept for the reference's keys
      and never run, in all three; the frozen world enhancer; PoseNetGT's
      detached extractors), always the same ones. DDP records them in the
      first step; ``find_unused_parameters`` would search the autograd
      graph for them every step, ~20 ms of the host's enqueue of a B=24
      step on the H100 (``PERF.md`` §6, PR 13).
    """
    import torch.distributed as dist

    set_batch_norm_group(model, dist.group.WORLD if group is None else group)
    return DistributedDataParallel(model, process_group=group,
                                   broadcast_buffers=False,
                                   gradient_as_bucket_view=True,
                                   static_graph=True)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module inside a ``DistributedDataParallel``, else ``model``."""
    return model.module if isinstance(model, DistributedDataParallel) else model


def shard_batch(batch, rank: int, world: int):
    """Rank ``rank``'s contiguous rows of every array or tensor leaf of a
    (nested dict) global batch, JAX's ``P(DATA_AXIS)`` over ``world``
    ranks."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, rank, world) for k, v in batch.items()}
    rows = batch.shape[0]
    if rows % world:
        raise ValueError(f"global batch {rows} not divisible by {world} hosts")
    per = rows // world
    return batch[rank * per:(rank + 1) * per]


def replicate(model: torch.nn.Module, devices) -> list:
    """One copy of ``model`` on each device, made once."""
    return [copy.deepcopy(model).to(d) for d in devices]


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def eval_forward_dp(model: torch.nn.Module, devices):
    """``forward(inputs) -> end_points`` over a replica of ``model`` (in
    eval mode) on each of ``devices``: each instance batch's rows are split
    evenly over them in order, each replica runs its share under its own
    device, the outputs are concatenated on the first device. A batch that
    does not divide by the device count raises."""
    devices = [torch.device(d) for d in devices]
    replicas = replicate(model, devices)
    n = len(devices)

    @torch.inference_mode()
    def forward(inputs: dict) -> dict:
        rows = len(next(iter(inputs.values())))
        if rows % n:
            raise ValueError(f"eval batch {rows} must divide by the "
                             f"{n}-device mesh")
        per = rows // n
        outs = []
        for i, (replica, device) in enumerate(zip(replicas, devices)):
            shard = {k: torch.as_tensor(v[i * per:(i + 1) * per]).to(device)
                     for k, v in inputs.items()}
            with _on(device):
                outs.append(replica(shard))
        first = devices[0]
        return {k: torch.cat([o[k].to(first) for o in outs])
                for k in outs[0]}

    return forward


def make_mesh_2d(dp: int, fsdp: int, device_type: str = "cuda"):
    """The ``(dp, fsdp)`` ``DeviceMesh`` over the process group, axes named
    ``("dp", "fsdp")``, rank ``r`` at ``(r // fsdp, r % fsdp)``. One process
    a device: the mesh covers the world."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * fsdp > world:
        raise ValueError(f"mesh {dp}x{fsdp} needs {dp * fsdp} devices, "
                         f"have {world}")
    if dp * fsdp < world:
        raise ValueError(f"mesh {dp}x{fsdp} leaves {world - dp * fsdp} of "
                         f"the {world} processes out; one process a device")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh_2d: no process group; join one with "
                           "parallel.multihost.initialize")
    return init_device_mesh(device_type, (dp, fsdp),
                            mesh_dim_names=(DATA_AXIS, FSDP_AXIS))


def _fsdp_leaf_dim(shape, fsdp_size: int) -> int | None:
    """The torch dim that JAX's ``_fsdp_leaf_spec`` shards for a weight of
    ``shape``: the largest axis in JAX's layout that ``fsdp_size`` divides,
    ties to the earliest; None where JAX replicates the leaf (under
    ``FSDP_MIN_SIZE`` elements, or no axis that ``fsdp_size`` divides)."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < FSDP_MIN_SIZE:
        return None
    order = JAX_AXIS_ORDER.get(len(shape), tuple(range(len(shape))))
    for i in sorted(range(len(order)), key=lambda i: -shape[order[i]]):
        size = shape[order[i]]
        if size % fsdp_size == 0 and size >= fsdp_size:
            return order[i]
    return None


def fsdp_shardings(mesh, model: torch.nn.Module) -> dict:
    """Each parameter's ``Shard(dim)`` over the mesh's ``fsdp`` axis, by
    name: JAX's axis where JAX shards it, dim 0 where JAX replicates it
    (FSDP2 shards every parameter)."""
    from torch.distributed.tensor import Shard

    fsdp = mesh[FSDP_AXIS].size()
    return {name: Shard(_fsdp_leaf_dim(p.shape, fsdp) or 0)
            for name, p in model.named_parameters()}


def state_shardings_fsdp(mesh, model: torch.nn.Module) -> dict:
    """The train state's plan by name: ``"params"`` (``fsdp_shardings``;
    each Adam moment takes its parameter's) and ``"buffers"``, the
    BatchNorm statistics, ``Replicate()`` on every rank."""
    from torch.distributed.tensor import Replicate

    return {"params": fsdp_shardings(mesh, model),
            "buffers": {name: Replicate()
                        for name, _ in model.named_buffers()}}


def shard_batch_2d(batch, rank: int, world: int):
    """Rank ``rank``'s rows of a global batch split over both mesh axes
    (JAX's ``P((DATA_AXIS, FSDP_AXIS))``): ``shard_batch`` over the
    flattened mesh."""
    return shard_batch(batch, rank, world)


def fsdp_units(model: torch.nn.Module) -> list:
    """The modules ``shard_state_fsdp`` shards one by one, children before
    their parents (the module docstring lists them)."""
    def units_of(m):
        if isinstance(m, ModifiedResnet):
            net = m.model
            return [net.feats.layer1, net.feats.layer2, net.feats.layer3,
                    net.feats.layer4, net.feats, net.psp, net.up_1,
                    net.up_2, m]
        if isinstance(m, PointNet2MSG):
            return [*m.SA_modules, *m.FP_modules]
        if m is getattr(model, "world_enhancer", None):
            return [*units_of(m.extractor), m.pose_estimator, m]
        return [m]
    return [u for child in model.children() for u in units_of(child)]


def shard_state_fsdp(mesh, model: torch.nn.Module) -> torch.nn.Module:
    """``model`` (on this process's device, every rank holding the same
    values) sharded in place over ``mesh`` by ``fsdp_shardings`` and
    returned, its BatchNorms' statistics over the whole world. Build the
    optimizer after this call."""
    from torch.distributed.fsdp import fully_shard

    plan = fsdp_shardings(mesh, model)
    placement = {id(p): plan[name] for name, p in model.named_parameters()}
    set_batch_norm_group(model, dist.group.WORLD)
    for unit in (*fsdp_units(model), model):
        fully_shard(unit, mesh=mesh, reshard_after_forward=True,
                    shard_placement_fn=lambda p: placement[id(p)])
    return model


def is_sharded(model: torch.nn.Module) -> bool:
    """Whether ``model`` went through ``shard_state_fsdp``."""
    from torch.distributed.fsdp import FSDPModule

    return isinstance(model, FSDPModule)
