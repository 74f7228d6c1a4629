"""The published IST-Net train step in plain PyTorch: forward, loss,
backward, Adam at the cyclic LR, then the scheduled BatchNorm
running-statistics update.

- LR: ``CyclicLR(triangular, base 1e-5, max 1e-3)``, half period
  ``max_epoch * iters_per_epoch / 6``, at the step count before the
  update, in float32.
- Adam with torch's defaults (betas 0.9 / 0.999, eps 1e-8, no weight
  decay): ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p -=
  lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) + eps)``; in the frozen
  recipe the world enhancer is not updated.
- BN momentum ``0.9 * 0.5 ** floor(step / 4000)`` clipped at 0.01; every
  BatchNorm that ran takes ``running = (1 - m) running + m batch``, the
  batch variance unbiased.
Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .model import BatchNorm, supervised_loss

_F = np.float32


def cyclic_lr(step: int, step_size_up: int, base: float = 1e-5,
              top: float = 1e-3) -> float:
    total = _F(2 * step_size_up)
    s = _F(step)
    cycle = np.floor(_F(1.0) + s / total)
    x = s / total - (cycle - _F(1.0))
    if x <= _F(0.5):
        scale = x * total / _F(step_size_up)
    else:
        scale = (total - x * total) / _F(step_size_up)
    return float(_F(base) + _F(top - base) * max(_F(0.0), scale))


def bn_momentum(step: int, mom: float = 0.9, decay: float = 0.5,
                decay_step: int = 4000, clip: float = 0.01) -> float:
    m = _F(mom) * _F(decay) ** np.floor(_F(step) / _F(decay_step))
    return float(max(m, _F(clip)))


class Adam:
    """Adam over ``params``; ``state[p]`` is ``(m, v)``."""

    def __init__(self, params, betas=(0.9, 0.999), eps=1e-8):
        self.params = list(params)
        self.b1, self.b2 = betas
        self.eps = eps
        self.t = 0
        self.state = {p: (torch.zeros_like(p), torch.zeros_like(p))
                      for p in self.params}

    @torch.no_grad()
    def step(self, lr: float) -> None:
        self.t += 1
        c1 = 1.0 - self.b1 ** self.t
        c2 = math.sqrt(1.0 - self.b2 ** self.t)
        for p in self.params:
            if p.grad is None:
                continue
            m, v = self.state[p]
            m.mul_(self.b1).add_(p.grad, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(p.grad, p.grad, value=1.0 - self.b2)
            p.addcdiv_(m, v.sqrt() / c2 + self.eps, value=-lr / c1)


class Step:
    """The train step of ``model`` (the reference ``ISTNet`` in train mode)
    under the recipe ``recipe``: ``gamma1``, ``gamma2``, ``frozen``,
    ``step_size_up``."""

    def __init__(self, model, recipe: dict):
        self.model, self.recipe = model, recipe
        self.frozen = bool(recipe["frozen"])
        self.opt = Adam(p for n, p in model.named_parameters()
                        if not (self.frozen and n.startswith("world_enhancer.")))
        self.bns = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def __call__(self, batch: dict, step: int, generator) -> dict:
        for bn in self.bns:
            bn.batch_mean = bn.batch_var = None
        for p in self.opt.params:
            p.grad = None
        total, parts = supervised_loss(
            self.model(batch["inputs"], generator), batch["labels"],
            self.recipe["gamma1"], self.recipe["gamma2"], self.frozen)
        total.backward()
        self.opt.step(cyclic_lr(step, self.recipe["step_size_up"]))
        m = bn_momentum(step)
        with torch.no_grad():
            for bn in self.bns:
                if bn.batch_mean is not None:
                    bn.running_mean.mul_(1.0 - m).add_(m * bn.batch_mean)
                    bn.running_var.mul_(1.0 - m).add_(m * bn.batch_var)
        return {k: float(v.detach()) for k, v in parts.items()}
