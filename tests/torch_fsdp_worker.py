"""The rank side of ``tests/test_torch_fsdp.py``: a process of a 4-rank
gloo group on the CPU (a ``file://`` rendezvous in the test's temporary
directory), started by ``parallel.multihost.spawn``, on a ``(dp, fsdp) =
(2, 2)`` mesh. It imports the port and torch only. Inputs come from the
parent as ``torch.save`` files (those of ``tests/torch_dp_worker.py``);
each job returns what every rank holds and rank 0 writes the whole
states the parent compares, float64 throughout."""

import torch
from torch.distributed.checkpoint.state_dict import (StateDictOptions,
                                                     get_state_dict)
from torch.distributed.tensor import DTensor

from istnet_tpu_torch.cli.train import state_digest
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.parallel import mesh, multihost
from istnet_tpu_torch.parallel.collectives import all_reduce_mean
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.train.train_state import make_optimizer, train_step
from torch_dp_worker import build

DP, FSDP = 2, 2


def full(t: torch.Tensor) -> torch.Tensor:
    """A tensor whole on this rank (an FSDP shard gathered)."""
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().clone()


def sharded_model(job: dict, device_mesh):
    """``job``'s model with its state, sharded over ``device_mesh``, and
    its optimizer built after the sharding."""
    model = build(job["arch"], job["freeze"])
    model.load_state_dict(job["state"], strict=True)
    mesh.shard_state_fsdp(device_mesh, model)
    return model, make_optimizer(model, job["cfg"])


def step(model, opt, job: dict, rank: int, world: int, k: int) -> dict:
    """Step ``k`` on this rank's rows of the job's batch; the loss parts
    averaged over the ranks."""
    parts = train_step(model, opt, mesh.shard_batch_2d(job["batch"], rank,
                                                       world),
                       k, torch.Generator(), job["cfg"])
    return {k: all_reduce_mean(v) for k, v in parts.items()}


def placements(t: DTensor) -> list:
    """A DTensor's placement on each mesh axis: the dim it is sharded on,
    None where it is replicated."""
    return [x.dim if x.is_shard() else None for x in t.placements]


def layout(model, opt, device_mesh) -> dict:
    """Where this rank's state lies: each parameter's placements, local
    shape and whether it has a gradient, its Adam moments' placements, the
    bytes of the local parameter and moment shards and of the whole ones,
    the BN buffers as held; and ``state_shardings_fsdp``'s plan, each
    placement on the ``fsdp`` axis as its dim (None: replicated)."""
    params, local, whole = {}, 0, 0
    for name, p in model.named_parameters():
        params[name] = {"dtensor": isinstance(p, DTensor),
                        "placements": placements(p),
                        "grad": p.grad is not None,
                        "local_shape": tuple(p.to_local().shape)}
        moments = opt.state.get(p, {})
        params[name]["moments"] = {k: placements(v)
                                   for k, v in moments.items()
                                   if isinstance(v, DTensor)}
        n = 1 + sum(1 for k in moments if k != "step")
        local += n * p.to_local().numel() * p.element_size()
        whole += n * p.numel() * p.element_size()
    buffers = {name: b.clone() for name, b in model.named_buffers()
               if not isinstance(b, DTensor)}
    plan = mesh.state_shardings_fsdp(device_mesh, model)
    return {"params": params, "local_bytes": local, "whole_bytes": whole,
            "buffers": buffers,
            "plan": {part: {k: x.dim if x.is_shard() else None
                            for k, x in placed.items()}
                     for part, placed in plan.items()}}


def step_job(rank: int, world: int, tmp: str, name: str,
             device_mesh) -> tuple[dict, tuple]:
    """One FSDP step of ``<name>.pt``'s model, config and global batch on
    this rank's rows. Returns the loss parts, the digest of the gathered
    updated state and the state's layout, and ``(job, model, optimizer)``
    after the step; rank 0 also writes the gathered gradients and updated
    state to ``<name>_fsdp.pt``."""
    job = torch.load(f"{tmp}/{name}.pt", weights_only=False)
    model, opt = sharded_model(job, device_mesh)
    parts = step(model, opt, job, rank, world, 0)
    grads = {n: full(p.grad) for n, p in model.named_parameters()
             if p.grad is not None}
    state = {k: full(v) for k, v in model.state_dict().items()}
    if rank == 0:
        torch.save({"parts": parts, "grads": grads, "state": state},
                   f"{tmp}/{name}_fsdp.pt")
    return ({"parts": {k: float(v) for k, v in parts.items()},
             "digest": state_digest(model),
             "layout": layout(model, opt, device_mesh)}, (job, model, opt))


def checkpoint_job(rank: int, world: int, tmp: str, job: dict, model, opt,
                   device_mesh) -> dict:
    """From ``step_job``'s state after step 0: a sharded save at epoch 1
    (extra meta keys), step 1 (the unbroken run); then a fresh sharded
    model and optimizer restored from the save take step 1 again. Returns
    the restore's step and meta, the digest of the saved state and whether
    the two step-1 runs agree in every bit (loss parts, state); rank 0
    writes the unbroken step-1 state to ``ckpt_unbroken.pt``."""
    ckpt = f"{tmp}/ckpt"
    checkpoints.save_checkpoint(ckpt, 1, model, opt, 1,
                                extra_meta={"iter": 1234, "wall_s": 2.5})
    saved = state_digest(model)
    unbroken = step(model, opt, job, rank, world, 1)
    want = {k: full(v) for k, v in model.state_dict().items()}
    if rank == 0:
        torch.save(want, f"{tmp}/ckpt_unbroken.pt")
    model, opt = sharded_model(job, device_mesh)
    restored_step, meta = checkpoints.restore_checkpoint_sharded(
        ckpt, 1, model, opt)
    resumed = step(model, opt, job, rank, world, restored_step)
    got = {k: full(v) for k, v in model.state_dict().items()}
    return {"step": restored_step, "meta": meta, "saved_digest": saved,
            "parts_equal": all(torch.equal(resumed[k], v)
                               for k, v in unbroken.items()),
            "state_differs": [k for k, v in want.items()
                              if not torch.equal(got[k], v)]}


def plain_resume_job(rank: int, world: int, tmp: str, name: str,
                     device_mesh) -> dict:
    """A fresh sharded model and optimizer restored by
    ``restore_checkpoint_sharded`` from the plain checkpoint ``plain/1``
    (one process's step 0, written by the parent), then step 1. Returns the
    restore's step and meta, and on rank 0 the keys of the gathered model
    state and Adam state (keyed by name) that differ from the file's in
    any bit or are missing on one side; rank 0 writes the loss parts and
    the step-1 state to ``plain_resumed.pt``."""
    job = torch.load(f"{tmp}/{name}.pt", weights_only=False)
    model, opt = sharded_model(job, device_mesh)
    ckpt = f"{tmp}/plain"
    restored_step, meta = checkpoints.restore_checkpoint_sharded(
        ckpt, 1, model, opt)
    model_state, optim_state = get_state_dict(
        model, opt, options=StateDictOptions(full_state_dict=True))
    differs = None
    if rank == 0:
        saved = torch.load(checkpoints.checkpoint_path(ckpt, 1),
                           weights_only=True)
        names = checkpoints._param_names(model, opt)
        want = {f"model.{k}": v for k, v in saved["model"].items()}
        want.update({f"optimizer.{names[i]}.{k}": v
                     for i, s in saved["optimizer"]["state"].items()
                     for k, v in s.items()})
        got = {f"model.{k}": v for k, v in model_state.items()}
        got.update({f"optimizer.{n}.{k}": v
                    for n, s in optim_state["state"].items()
                    for k, v in s.items()})
        differs = sorted(set(want) ^ set(got)) + [
            k for k in want if k in got and not torch.equal(got[k], want[k])]
    parts = step(model, opt, job, rank, world, restored_step)
    state = {k: full(v) for k, v in model.state_dict().items()}
    if rank == 0:
        torch.save({"parts": parts, "state": state},
                   f"{tmp}/plain_resumed.pt")
    return {"step": restored_step, "meta": meta, "differs": differs}


def mesh_job(world: int) -> str:
    """``make_mesh_2d`` asked for more devices than the world: its error."""
    try:
        mesh.make_mesh_2d(world, 2, "cpu")
    except ValueError as e:
        return str(e)
    return "no error"


def run(rank: int, world: int, store, tmp: str, jobs) -> dict:
    """Join the group through ``tmp``'s rendezvous file, build the ``(2,
    2)`` mesh and run ``jobs`` (``"mesh"``, ``"ckpt:<recipe>"`` or a
    recipe's name, ``"ckpt:<recipe>"`` after that recipe, or
    ``"plain:<recipe>"``) in order."""
    torch.set_num_threads(1)
    multihost.initialize("cpu", init_method=f"file://{tmp}/rendezvous",
                         rank=rank, world_size=world)
    precision.set_compute_dtype(torch.float64)
    try:
        device_mesh = mesh.make_mesh_2d(DP, FSDP, "cpu")
        out = {"coordinate": device_mesh.get_coordinate()}
        stepped = {}       # a recipe's state after step 0, kept for ckpt:
        for job in jobs:
            if job == "mesh":
                out[job] = mesh_job(world)
            elif job.startswith("ckpt:"):
                out[job] = checkpoint_job(rank, world, tmp,
                                          *stepped.pop(job[5:]), device_mesh)
            elif job.startswith("plain:"):
                out[job] = plain_resume_job(rank, world, tmp, job[6:],
                                            device_mesh)
            else:
                out[job], state = step_job(rank, world, tmp, job, device_mesh)
                if f"ckpt:{job}" in jobs:
                    stepped[job] = state
        return out
    finally:
        multihost.shutdown()
