"""Training checkpoints and the two-phase transplant (counterpart of
``istnet_tpu/train/checkpoints.py``).

A checkpoint is one directory per epoch under ``ckpt_dir`` (the layout
Orbax gives the JAX package), holding ``checkpoint.pt``: ``torch.save`` of
``{"model": state_dict, "optimizer": state_dict, "step": int, "meta":
{"epoch": int, ...}}``. Tensors are saved on the device they lie on and
read back onto the CPU (``restore_for_eval`` takes another
``map_location``), so a checkpoint written on the card restores on a host
without one. Data parallel, every rank calls ``save_checkpoint``: rank 0
writes the state of the module inside the DDP wrapper (the reference keys,
no ``module.`` prefix), then all ranks meet at a barrier; every rank
restores the same file. The dropout generator is not saved: as in
JAX, a resumed run seeds it again from ``rd_seed`` and rebuilds its
datasets from the seed, so it is not the unbroken run.

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
from istnet_tpu_torch.parallel.mesh import unwrap

FILE = "checkpoint.pt"


def checkpoint_path(ckpt_dir: str, epoch: int) -> str:
    """Where epoch ``epoch``'s checkpoint lies under ``ckpt_dir``."""
    return os.path.join(ckpt_dir, str(int(epoch)), FILE)


def save_checkpoint(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                    optimizer: torch.optim.Optimizer, step: int,
                    extra_meta: dict | None = None) -> str:
    """Write ``ckpt_dir/<epoch>/checkpoint.pt`` (through a temporary file,
    so that a cut run leaves no half-written checkpoint; rank 0 writes,
    then every rank waits for it); returns its path."""
    path = checkpoint_path(ckpt_dir, epoch)
    if multihost.process_index() == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"model": unwrap(model).state_dict(),
                   "optimizer": optimizer.state_dict(),
                   "step": int(step),
                   "meta": {"epoch": int(epoch), **(extra_meta or {})}}
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    multihost.barrier()
    return path


def latest_epoch(ckpt_dir: str) -> int | None:
    """The largest epoch with a checkpoint under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    epochs = [int(d) for d in os.listdir(ckpt_dir)
              if d.isdigit() and os.path.exists(checkpoint_path(ckpt_dir, int(d)))]
    return max(epochs, default=None)


def _load(ckpt_dir: str, epoch: int, map_location) -> dict:
    path = checkpoint_path(ckpt_dir, epoch)
    if not os.path.exists(path):
        raise FileNotFoundError(f"no checkpoint of epoch {epoch} under "
                                f"{ckpt_dir}")
    return torch.load(path, map_location=map_location, weights_only=True)


def restore_checkpoint(ckpt_dir: str, epoch: int, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer | None = None) -> dict:
    """Load epoch ``epoch``'s model state into ``model`` (strict) and, if
    given, its optimizer state into ``optimizer``, which must be built as
    the saved run built it (same parameters in the same order). The file
    is read onto the CPU and each tensor goes where the live one lies: the
    parameters' and moments' device, while Adam's step counts stay on the
    CPU as in a fresh run (on the card, every update would read them back
    with a sync). Returns the payload (``step``, ``meta``)."""
    payload = _load(ckpt_dir, epoch, "cpu")
    unwrap(model).load_state_dict(payload["model"], strict=True)
    if optimizer is not None:
        optimizer.load_state_dict(payload["optimizer"])
    return payload


def restore_for_eval(ckpt_dir: str, epoch: int, map_location="cpu") -> dict:
    """Epoch ``epoch``'s payload without a model to load it into; its
    ``"model"`` entry is a state dict for ``load_state_dict``."""
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
