"""The optimizer and the train step (counterpart of
``istnet_tpu/train/train_state.py``).

- Adam with torch's default betas and eps unless ``adam_betas`` /
  ``adam_eps`` say otherwise: the reference's solver never passes the
  config's ``betas`` / ``eps`` keys, and its ``make_optimizer`` reads only
  these two overrides (``istnet_tpu/train/train_state.py:56-75``). Its LR
  is set from the cyclic schedule at the step count before each update, the
  count optax's schedule sees.
- The frozen recipe leaves ``world_enhancer.*`` out of the optimizer (JAX
  zeroes that subtree's updates with ``optax.set_to_zero``); its BNs still
  update their running statistics, as the reference's do.
- BatchNorm running statistics: after the update, every BN that ran in the
  step takes ``running = (1 - m) * running + m * batch`` with ``m =
  bn_momentum(step)``, its batch statistics published by the forward
  (``nn/layers.py::BatchNorm``).
- The reference computes its synthetic and real losses separately and
  weights them by batch size; every term is a batch mean, so that equals
  the loss of the concatenated batch, which is what one step takes.
- The device input pipeline (``use_device_preprocess`` /
  ``use_device_aug``) runs inside the step, as JAX's ``make_train_step``
  hooks run it: ``preprocess_fn`` turns a raw batch into inputs and labels,
  ``augment_fn`` applies the FS-Net augmentation, both without a graph and
  with their draws taken from the step's generator before the dropout's.
- Data parallel: ``model`` may be the ``DistributedDataParallel`` of
  ``parallel.mesh.wrap_dp`` (one process a device, global-batch
  BatchNorm); the BNs and the optimizer's parameters are the inner
  module's, and each rank returns its own rows' loss parts (the Solver
  averages them over the ranks).
- The step repeats bit for bit on the card: its forward and backward run
  with cuDNN restricted to deterministic algorithms
  (``deterministic_cudnn``), and the model's own backward sums (the PSP
  resize, the per-point gather, the kernels' scatters) run in a fixed
  order.
- ``TrainConfig.from_config`` reads a YAML config as
  ``istnet_tpu/cli/train.py`` and ``make_optimizer`` read it; its
  ``model_arch`` picks the loss: ``ist_net`` (``supervised_loss``) or
  ``posenet_gt`` (PoseNetGT's pose distance).
- Under a profiler a step is the span ``step`` (its item the step count)
  around ``step.prepare``, ``step.start``, ``step.loss`` (the model's
  ``forward`` inside), ``step.backward`` and ``step.update`` (``adam``,
  then ``bn_ema``; ``utils/tracing.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from istnet_tpu_torch.models import posenet_gt
from istnet_tpu_torch.models.ist_net import supervised_loss
from istnet_tpu_torch.nn.layers import BatchNorm
from istnet_tpu_torch.parallel.mesh import unwrap
from istnet_tpu_torch.train.schedules import bn_momentum, cyclic_triangular_lr
from istnet_tpu_torch.utils.tracing import span


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The recipe's knobs, with ``config/ist_net_default.yaml``'s values."""

    model_arch: str = "ist_net"
    gamma1: float = 1.0
    gamma2: float = 10.0
    freeze_world_enhancer: bool = False
    max_epoch: int = 30
    iters_per_epoch: int = 4000
    weight_decay: float = 0.0
    bn_momentum: float = 0.9
    bn_decay: float = 0.5
    decay_step: int = 4000
    bnm_clip: float = 0.01
    adam_betas: tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8

    @classmethod
    def frozen(cls, **kw) -> "TrainConfig":
        """``config/ist_net_freeze_world_enhancer.yaml``: gamma2 100, the
        world enhancer frozen."""
        return cls(**{"gamma2": 100.0, "freeze_world_enhancer": True, **kw})

    @classmethod
    def from_config(cls, cfg) -> "TrainConfig":
        """The knobs of a YAML config (``utils.config.Config``): the loss
        weights, the recipe, the epoch length, weight decay, the BN
        schedule and only ``optimizer.adam_betas`` / ``adam_eps`` (the
        configs' ``betas`` / ``eps`` never reach the reference's Adam)."""
        arch = cfg.get("model_arch", "ist_net")
        if arch not in ("ist_net", "posenet_gt"):
            raise ValueError(f"unknown model_arch {arch}")
        opt, bn = cfg.optimizer, cfg.bn
        loss = cfg.get("loss") or {}
        betas = opt.get("adam_betas", cls.adam_betas)
        gammas = {k: float(loss[k]) for k in ("gamma1", "gamma2") if k in loss}
        return cls(
            model_arch=arch, **gammas,
            freeze_world_enhancer=(arch == "ist_net" and bool(
                cfg.get("freeze_world_enhancer", False))),
            max_epoch=int(cfg.max_epoch),
            iters_per_epoch=int(cfg.get("num_mini_batch_per_epoch", 4000)),
            weight_decay=float(opt.get("weight_decay", 0.0)),
            bn_momentum=float(bn.bn_momentum), bn_decay=float(bn.bn_decay),
            decay_step=int(bn.decay_step), bnm_clip=float(bn.bnm_clip),
            adam_betas=(float(betas[0]), float(betas[1])),
            adam_eps=float(opt.get("adam_eps", cls.adam_eps)))

    @property
    def step_size_up(self) -> int:
        """The cyclic LR's half period (the reference's solver)."""
        return max(1, int(self.max_epoch * self.iters_per_epoch / 6))

    def lr(self, step: int) -> float:
        return cyclic_triangular_lr(step, base_lr=1e-5, max_lr=1e-3,
                                    step_size_up=self.step_size_up)

    def momentum(self, step: int) -> float:
        return bn_momentum(step, self.bn_momentum, self.bn_decay,
                           self.decay_step, self.bnm_clip)


def make_optimizer(model: torch.nn.Module,
                   cfg: TrainConfig) -> torch.optim.Adam:
    """Adam over the trainable parameters (all but ``world_enhancer.*``
    in the frozen recipe) of ``model`` (or of the module a DDP wrapper
    holds); ``train_step`` sets its LR every step."""
    params = [p for name, p in unwrap(model).named_parameters()
              if not (cfg.freeze_world_enhancer
                      and name.startswith("world_enhancer."))]
    return torch.optim.Adam(params, lr=cfg.lr(0),
                            betas=tuple(cfg.adam_betas), eps=cfg.adam_eps,
                            weight_decay=cfg.weight_decay)


def batch_norms(model: torch.nn.Module) -> list[BatchNorm]:
    return [m for m in model.modules() if isinstance(m, BatchNorm)]


@torch.no_grad()
def update_bn_stats(model: torch.nn.Module, momentum: float) -> int:
    """The scheduled EMA of every BN that published batch statistics in
    the last forward; returns how many did."""
    count = 0
    for bn in batch_norms(model):
        if bn.batch_mean is None:
            continue
        bn.running_mean.copy_((1.0 - momentum) * bn.running_mean
                              + momentum * bn.batch_mean)
        bn.running_var.copy_((1.0 - momentum) * bn.running_var
                             + momentum * bn.batch_var)
        bn.num_batches_tracked += 1
        count += 1
    return count


def start_step(model: torch.nn.Module, optimizer: torch.optim.Adam,
               step: int, cfg: TrainConfig) -> None:
    """The first part of ``train_step``: clear the BNs' published batch
    statistics, set the LR of step count ``step``, drop the gradients."""
    if not model.training:
        raise ValueError("train_step needs the model in train mode "
                         "(model.train())")
    for bn in batch_norms(model):
        bn.batch_mean = bn.batch_var = None
    lr = cfg.lr(step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    optimizer.zero_grad(set_to_none=True)


def step_loss(model: torch.nn.Module, batch: dict,
              generator: torch.Generator, cfg: TrainConfig):
    """The forward and the loss of ``cfg.model_arch``: ``(total, parts)``."""
    end_points = model(batch["inputs"], generator)
    if cfg.model_arch == "posenet_gt":
        return posenet_gt.supervised_loss(end_points, batch["labels"])
    return supervised_loss(end_points, batch["labels"], cfg.gamma1,
                           cfg.gamma2, cfg.freeze_world_enhancer)


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to its deterministic algorithms, then set back: the
    weight gradients of the RGB trunk's convolutions otherwise come from
    algorithms that sum in no fixed order, and two steps from one state
    differ in their bits."""
    was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = was


def finish_step(model: torch.nn.Module, optimizer: torch.optim.Adam,
                step: int, cfg: TrainConfig) -> None:
    """The update after the backward: Adam, then the scheduled BN EMA."""
    with span("adam"):
        optimizer.step()
    with span("bn_ema"):
        update_bn_stats(model, cfg.momentum(step))


def prepare_batch(batch: dict, generator: torch.Generator,
                  preprocess_fn=None, augment_fn=None) -> dict:
    """The step's input pipeline, without a graph: ``preprocess_fn(raw,
    generator) -> {"inputs", "labels"}`` when ``batch`` is a raw batch,
    then ``augment_fn(batch, generator)``; their draws come from
    ``generator`` in that order, before the forward's dropout masks."""
    with torch.no_grad():
        if preprocess_fn is not None:
            batch = preprocess_fn(batch, generator)
        if augment_fn is not None:
            batch = augment_fn(batch, generator)
    return batch


def train_step(model: torch.nn.Module, optimizer: torch.optim.Adam,
               batch: dict, step: int, generator: torch.Generator,
               cfg: TrainConfig, preprocess_fn=None, augment_fn=None) -> dict:
    """One update of ``model`` (in train mode) on ``batch`` (``{"inputs",
    "labels"}``, or a raw batch with ``preprocess_fn``) at step count
    ``step`` (0 for the first), the input pipeline's draws
    (``prepare_batch``) and the dropout masks from ``generator``. Returns
    the detached loss parts (``total`` and the terms of
    ``supervised_loss``)."""
    with span("step", item=step):
        with span("step.prepare"):
            batch = prepare_batch(batch, generator, preprocess_fn,
                                  augment_fn)
        with span("step.start"):
            start_step(model, optimizer, step, cfg)
        with deterministic_cudnn():
            with span("step.loss"):
                total, parts = step_loss(model, batch, generator, cfg)
            with span("step.backward"):
                total.backward()
        with span("step.update"):
            finish_step(model, optimizer, step, cfg)
        return {k: v.detach() for k, v in parts.items()}
