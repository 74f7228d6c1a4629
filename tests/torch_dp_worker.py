"""The rank side of ``tests/test_torch_parallel.py``: a process of a 2-rank
gloo group on the CPU (a ``file://`` rendezvous in the test's temporary
directory), started by ``parallel.multihost.spawn``. It imports the port
and torch only. Inputs come from the parent as ``torch.save`` files; each
job writes what the parent compares, float64 throughout."""

import torch

from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.models.posenet_gt import PoseNetGT
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.parallel import multihost
from istnet_tpu_torch.parallel.collectives import all_reduce_mean
from istnet_tpu_torch.parallel.mesh import (
    set_batch_norm_group,
    shard_batch,
    wrap_dp,
)
from istnet_tpu_torch.train.train_state import make_optimizer, train_step

TINY = (32, 16, 8, 8)


def build(arch: str, freeze: bool) -> torch.nn.Module:
    """The tiny model of ``arch`` in float64, train mode, dropout off."""
    model = (PoseNetGT(sa_npoints=TINY) if arch == "posenet_gt" else
             ISTNet(sa_npoints=TINY, freeze_world_enhancer=freeze))
    return dropout_off(model)


def dropout_off(model: torch.nn.Module) -> torch.nn.Module:
    model.to(torch.float64).train()
    for m in model.modules():
        if isinstance(m, layers.Dropout2d):
            m.eval()
    return model


def batch_norm_job(rank: int, world: int, tmp: str) -> dict:
    """A train-mode BatchNorm over this rank's rows of ``bn.pt``'s input,
    its statistics over the group; the output's gradient against the
    rank's rows of the cotangent."""
    data = torch.load(f"{tmp}/bn.pt")
    bn = layers.BatchNorm(data["x"].shape[-1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(data["weight"])
        bn.bias.copy_(data["bias"])
    set_batch_norm_group(bn, torch.distributed.group.WORLD)
    x = shard_batch(data["x"], rank, world).clone().requires_grad_()
    y = bn(x)
    (y * shard_batch(data["cot"], rank, world)).sum().backward()
    return {"y": y.detach(), "x_grad": x.grad, "mean": bn.batch_mean,
            "var": bn.batch_var, "weight_grad": bn.weight.grad,
            "bias_grad": bn.bias.grad}


def step_job(rank: int, world: int, tmp: str, name: str) -> str:
    """One DDP step of ``<name>.pt``'s model, config and global batch on
    this rank's rows; writes the loss parts averaged over the ranks, the
    gradients and the updated state to ``<name>_<rank>.pt``."""
    job = torch.load(f"{tmp}/{name}.pt", weights_only=False)
    model = build(job["arch"], job["freeze"])
    model.load_state_dict(job["state"], strict=True)
    opt = make_optimizer(model, job["cfg"])
    parts = train_step(wrap_dp(model), opt,
                       shard_batch(job["batch"], rank, world), 0,
                       torch.Generator(), job["cfg"])
    out = f"{tmp}/{name}_{rank}.pt"
    torch.save({"parts": {k: all_reduce_mean(v) for k, v in parts.items()},
                "grads": {n: p.grad.clone() for n, p in model.named_parameters()
                          if p.grad is not None},
                "state": model.state_dict()}, out)
    return out


def run(rank: int, world: int, store, tmp: str, jobs) -> dict:
    """Join the group through ``tmp``'s rendezvous file and run ``jobs``
    (``"bn"`` or the name of a step job) in order."""
    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=f"file://{tmp}/rendezvous",
                         rank=rank, world_size=world)
    precision.set_compute_dtype(torch.float64)
    try:
        return {job: (batch_norm_job(rank, world, tmp) if job == "bn"
                      else step_job(rank, world, tmp, job)) for job in jobs}
    finally:
        multihost.shutdown()
