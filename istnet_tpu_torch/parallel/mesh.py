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

FSDP (``make_mesh_2d``, the ``*_fsdp`` functions) is not ported yet: those
names raise, naming ROADMAP.md queue 1, item 10.
"""

from __future__ import annotations

import contextlib
import copy

import torch
from torch.nn.parallel import DistributedDataParallel

from istnet_tpu_torch.nn.layers import BatchNorm

FSDP_NOT_YET = ("FSDP (parallel: {fsdp: N > 1}) is not ported yet: "
                "ROADMAP.md queue 1, item 10")


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


def _fsdp_not_yet(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(f"{name}: {FSDP_NOT_YET}")
    refuse.__name__ = name
    return refuse


make_mesh_2d = _fsdp_not_yet("make_mesh_2d")
fsdp_shardings = _fsdp_not_yet("fsdp_shardings")
state_shardings_fsdp = _fsdp_not_yet("state_shardings_fsdp")
shard_batch_2d = _fsdp_not_yet("shard_batch_2d")
shard_state_fsdp = _fsdp_not_yet("shard_state_fsdp")
jit_train_step_fsdp = _fsdp_not_yet("jit_train_step_fsdp")
