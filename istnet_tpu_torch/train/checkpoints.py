"""Training checkpoints and the two-phase transplant (counterpart of
``istnet_tpu/train/checkpoints.py``).

A checkpoint is one directory per epoch under ``ckpt_dir`` (the layout
Orbax gives the JAX package), in one of two layouts:

- plain (one device, DDP): ``checkpoint.pt``, ``torch.save`` of
  ``{"model": state_dict, "optimizer": state_dict, "step": int, "meta":
  {"epoch": int, ...}}``. Rank 0 writes the state of the module inside the
  DDP wrapper (the reference keys, no ``module.`` prefix; first removing
  a sharded checkpoint's ``meta.pt`` of the same epoch), then all ranks
  meet at a barrier; every rank restores the same file.
- sharded (FSDP, ``parallel/mesh.py::shard_state_fsdp``): every rank
  writes its own shards with ``torch.distributed.checkpoint`` (DCP: a
  ``.metadata`` file and a ``__<rank>_0.distcp`` file a writer) from
  ``get_state_dict(model, optimizer)``, the optimizer state keyed by
  parameter name; rank 0 then writes ``meta.pt`` (``step`` and ``meta``),
  whose presence marks the checkpoint whole (rank 0 removes an earlier
  one, and a plain ``checkpoint.pt``, before any rank writes).
  ``restore_checkpoint_sharded`` reads each rank's shards straight into the
  sharded model and optimizer; from a plain checkpoint, rank 0 reads the
  file and every rank takes its shards from rank 0's broadcast, so a
  one-device or DDP run resumes under FSDP.

``latest_epoch``, ``restore_checkpoint`` and ``restore_for_eval`` read
both layouts, a sharded one in one process without a group (the
parameters whole, the optimizer state keyed by index as the plain
optimizer's): ``cli/test.py`` evaluates an FSDP run, and a plain or DDP run
resumes from one (JAX's "restore it both ways",
``tests/test_fsdp.py:158-214``). Tensors are read onto the CPU
(``restore_for_eval`` takes another ``map_location``), so a checkpoint
written on the card restores on a host without one. The dropout generator
is not saved: as in JAX, a resumed run seeds it again from ``rd_seed`` and
rebuilds its datasets from the seed, so it is not the unbroken run.

``load_world_enhancer`` moves PoseNetGT's ``pts_gt_extractor`` into
IST-Net's ``world_enhancer.extractor``: parameters and BN buffers, as the
reference's torch load of the renamed keys does. Its source is the port's
checkpoint directory, a reference ``.pth`` or a ``.npz`` of JAX trees.
"""

from __future__ import annotations

import os

import torch

from istnet_tpu_torch import convert
from istnet_tpu_torch.parallel import multihost
from istnet_tpu_torch.parallel.mesh import is_sharded, unwrap

FILE = "checkpoint.pt"
META = "meta.pt"          # a sharded checkpoint's step and meta


def epoch_dir(ckpt_dir: str, epoch: int) -> str:
    """The directory of epoch ``epoch``'s checkpoint, either layout."""
    return os.path.join(ckpt_dir, str(int(epoch)))


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    """Where epoch ``epoch``'s plain checkpoint lies under ``ckpt_dir``."""
    return os.path.join(epoch_dir(ckpt_dir, epoch), FILE)


def is_sharded_checkpoint(ckpt_dir: str, epoch: int) -> bool:
    """Whether epoch ``epoch`` holds a whole sharded checkpoint."""
    return os.path.exists(os.path.join(epoch_dir(ckpt_dir, epoch), META))


def has_checkpoint(ckpt_dir: str, epoch: int) -> bool:
    """Whether epoch ``epoch`` holds a whole checkpoint of either layout."""
    return (os.path.exists(checkpoint_path(ckpt_dir, epoch))
            or is_sharded_checkpoint(ckpt_dir, epoch))


def save_checkpoint(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    extra_meta: dict | None = None) -> str:
    """Write epoch ``epoch``'s checkpoint; every rank calls it and returns
    its path. Plain: ``ckpt_dir/<epoch>/checkpoint.pt`` through a temporary
    file, so that a cut run leaves no half-written checkpoint (rank 0
    writes, then every rank waits for it). A sharded ``model``: the
    sharded layout in ``ckpt_dir/<epoch>/``."""
    payload = {"step": int(step),
               "meta": {"epoch": int(epoch), **(extra_meta or {})}}
    if is_sharded(model):
        return _save_sharded(epoch_dir(ckpt_dir, epoch), model, optimizer,
                             payload)
    path = checkpoint_path(ckpt_dir, epoch)
    if multihost.process_index() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        _remove(os.path.join(os.path.dirname(path), META))
        payload = {"model": unwrap(model).state_dict(),
                   "optimizer": optimizer.state_dict(), **payload}
        _write(payload, path)
    multihost.barrier()
    return path


def _remove(path: str) -> None:
    if os.path.exists(path):
        os.remove(path)


def _write(payload: dict, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _save_sharded(path: str, model, optimizer, payload: dict) -> str:
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model_state, optim_state = get_state_dict(model, optimizer)
    # an earlier checkpoint of this epoch stops marking it whole before any
    # shard of this one is written
    if multihost.process_index() == 0:
        _remove(os.path.join(path, META))
        _remove(os.path.join(path, FILE))
    multihost.barrier()
    dcp.save({"model": model_state, "optimizer": optim_state},
             checkpoint_id=path)
    if multihost.process_index() == 0:
        _write(payload, os.path.join(path, META))
    multihost.barrier()
    return path


def latest_epoch(ckpt_dir: str) -> int | None:
    """The largest epoch with a checkpoint under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(d) for d in os.listdir(ckpt_dir)
              if d.isdigit() and has_checkpoint(ckpt_dir, int(d))]
    return max(epochs, default=None)


def _read_sharded(path: str) -> dict:
    """A sharded checkpoint read whole into this process, no group needed:
    ``{"model", "optimizer"}`` as saved. The read of
    ``format_utils.dcp_to_torch_save``, without its copy to a file: DCP's
    planner that rebuilds the state dict from the checkpoint's metadata.
    Both names are private to torch and this is the one place that uses
    them; ``tests/test_torch_fsdp.py`` fails by name if a torch release
    drops them."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.default_planner import (
        _EmptyStateDictLoadPlanner)
    from torch.distributed.checkpoint.state_dict_loader import (
        _load_state_dict)

    state: dict = {}
    _load_state_dict(state, storage_reader=dcp.FileSystemReader(path),
                     planner=_EmptyStateDictLoadPlanner(), no_dist=True)
    return state


def _load(ckpt_dir: str, epoch: int, map_location) -> dict:
    if is_sharded_checkpoint(ckpt_dir, epoch):
        path = epoch_dir(ckpt_dir, epoch)
        payload = {**_read_sharded(path),
                   **torch.load(os.path.join(path, META), weights_only=True)}
        return _to(payload, torch.device(map_location))
    path = checkpoint_path(ckpt_dir, epoch)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint of epoch {epoch} under "
                                f"{ckpt_dir}")
    return torch.load(path, map_location=map_location, weights_only=True)


def _to(tree, device: torch.device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


def _param_names(model: torch.nn.Module,
                 optimizer: torch.optim.Optimizer) -> list[str]:
    """The names of ``optimizer``'s parameters in its order, the order of
    the indices that ``optimizer.state_dict()`` keys its state by."""
    names = {id(p): n for n, p in unwrap(model).named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups for p in g["params"]]


def _rekey(saved: dict, key: dict) -> dict:
    """An optimizer state dict with each parameter's key mapped by
    ``key``."""
    return {"state": {key[n]: s for n, s in saved["state"].items()},
            "param_groups": [{**g, "params": [key[n] for n in g["params"]]}
                             for g in saved["param_groups"]]}


def _optimizer_by_index(saved: dict, model: torch.nn.Module,
                        optimizer: torch.optim.Optimizer) -> dict:
    """A sharded checkpoint's optimizer state (keyed by parameter name) as
    ``optimizer.state_dict()`` keys it: by the parameters' order in
    ``optimizer``."""
    names = _param_names(model, optimizer)
    return _rekey(saved, {n: i for i, n in enumerate(names)})


def restore_checkpoint(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer | None = None) -> dict:
    """Load epoch ``epoch``'s model state into ``model`` (strict) and, if
    given, its optimizer state into ``optimizer``, which must be built as
    the saved run built it (same parameters in the same order). The file
    is read onto the CPU and each tensor goes where the live one lies: the
    parameters' and moments' device, while Adam's step counts stay on the
    CPU as in a fresh run (on the card, every update would read them back
    with a sync). Either layout. Returns the payload (``step``,
    ``meta``)."""
    payload = _load(ckpt_dir, epoch, "cpu")
    unwrap(model).load_state_dict(payload["model"], strict=True)
    if optimizer is not None:
        saved = payload["optimizer"]
        if is_sharded_checkpoint(ckpt_dir, epoch):
            saved = _optimizer_by_index(saved, model, optimizer)
        optimizer.load_state_dict(saved)
    return payload


def restore_checkpoint_sharded(ckpt_dir: str, epoch: int,
                               model: torch.nn.Module,
                               optimizer: torch.optim.Optimizer
                               ) -> tuple[int, dict]:
    """Read epoch ``epoch``'s checkpoint into a model sharded by
    ``shard_state_fsdp`` and its optimizer, built after the sharding as the
    saved run built it. Every rank calls it. Returns ``(step, meta)``.

    A sharded checkpoint (written over the same mesh): each rank reads its
    own shards, never the whole state. A plain one (one device or DDP):
    rank 0 reads the file, and every rank takes its shards of each tensor
    from rank 0's broadcast."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, get_state_dict, set_model_state_dict,
        set_optimizer_state_dict)

    path = epoch_dir(ckpt_dir, epoch)
    if not is_sharded_checkpoint(ckpt_dir, epoch):
        return _restore_plain_sharded(ckpt_dir, epoch, model, optimizer)
    model_state, optim_state = get_state_dict(model, optimizer)
    # the template has a state for every parameter; Adam saved none for
    # those that never had a gradient (the trunk's classifier, frozen or
    # detached extractors), and they must stay without one
    saved = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    optim_state["state"] = {
        name: s for name, s in optim_state["state"].items()
        if any(f"optimizer.state.{name}.{k}" in saved for k in s)}
    dcp.load({"model": model_state, "optimizer": optim_state},
             checkpoint_id=path)
    set_model_state_dict(model, model_state)
    set_optimizer_state_dict(model, optimizer, optim_state,
                             options=StateDictOptions(strict=False))
    payload = torch.load(os.path.join(path, META), weights_only=True)
    return int(payload["step"]), payload["meta"]


def _restore_plain_sharded(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                           optimizer: torch.optim.Optimizer
                           ) -> tuple[int, dict]:
    """``restore_checkpoint_sharded`` from a plain checkpoint: rank 0 reads
    it (its optimizer state keyed by name), ``set_model_state_dict`` and
    ``set_optimizer_state_dict`` broadcast each tensor from rank 0 and keep
    every rank's shard of it."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions, set_model_state_dict, set_optimizer_state_dict)

    if not os.path.exists(checkpoint_path(ckpt_dir, epoch)):
        raise FileNotFoundError(f"no checkpoint of epoch {epoch} under "
                                f"{ckpt_dir}")
    names = _param_names(model, optimizer)
    head = [None]
    model_state, optim_state = {}, {}
    if multihost.process_index() == 0:
        payload = _load(ckpt_dir, epoch, "cpu")
        model_state = payload["model"]
        optim_state = _rekey(payload["optimizer"], dict(enumerate(names)))
        head = [(int(payload["step"]), payload["meta"],
                 set(optim_state["state"]))]
    dist.broadcast_object_list(head, src=0)
    step, meta, with_state = head[0]
    set_model_state_dict(model, model_state, options=StateDictOptions(
        full_state_dict=True, broadcast_from_rank0=True))
    # not strict: the saved run's Adam has no state for the parameters it
    # never updated, and the template (a step of zero gradients) holds one
    # for every parameter; those stay without one
    set_optimizer_state_dict(model, optimizer, optim_state,
                             options=StateDictOptions(
                                 full_state_dict=True,
                                 broadcast_from_rank0=True, strict=False))
    params = dict(unwrap(model).named_parameters())
    for name in names:
        if name not in with_state:
            optimizer.state.pop(params[name], None)
    return step, meta


def restore_for_eval(ckpt_dir: str, epoch: int, map_location="cpu") -> dict:
    """Epoch ``epoch``'s payload (either layout) without a model to load it
    into; its ``"model"`` entry is a state dict for ``load_state_dict``
    (a sharded checkpoint's parameters whole, its ``"optimizer"`` keyed by
    parameter name)."""
    return _load(ckpt_dir, epoch, map_location)


SRC_PREFIX, DST_PREFIX = "pts_gt_extractor.", "world_enhancer.extractor."


def load_world_enhancer(source: str, epoch: int, model: torch.nn.Module) -> int:
    """Copy PoseNetGT's ``pts_gt_extractor.*`` (parameters and BN buffers)
    from ``source`` into ``model.world_enhancer.extractor``. ``source`` is
    a checkpoint directory of the port (``epoch`` picks the checkpoint), a
    reference ``.pth`` or a ``.npz`` of JAX trees (``epoch`` unused).
    Returns the number of tensors moved; a missing key raises."""
    if source.endswith((".npz", ".pth", ".pt")):
        state = convert.load_weights(source, "posenet_gt")
    else:
        state = restore_for_eval(source, epoch)["model"]
    own = model.state_dict()
    want = [k for k in own if k.startswith(DST_PREFIX)]
    moved = {}
    for key in want:
        src = SRC_PREFIX + key[len(DST_PREFIX):]
        if src not in state:
            raise KeyError(f"{source}: no {src} for {key}")
        moved[key] = state[src]
    with torch.no_grad():
        for key, value in moved.items():
            own[key].copy_(value)
    return len(moved)
