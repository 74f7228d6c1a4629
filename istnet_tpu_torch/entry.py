"""Build the production-shape IST-Net eval forward and its inputs.

Counterpart of ``__graft_entry__.entry()`` / ``_make_inputs``: the full-width
``ISTNet`` (6 classes, SA npoints 512/256/128/64) on an explicit device, and
a batch of instance crops (B=32, N=1024 points, 192 x 192 RGB) made from a
numpy ``RandomState(seed)`` exactly as the JAX entry makes them.

``build_serving_model`` sets a compute policy first, as ``bench.py:96-99``
sets the bf16 deployment precision before ``entry()``.

Weights are random: torch's default layer init drawn from a
``torch.Generator`` (the ResNet trunk's convs with the reference's
normal(0, sqrt(2/n)) init), then BatchNorm statistics and affines and the
PReLU slopes set to non-trivial values from a numpy seed, so that a swapped
or skipped normalisation changes the outputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.nn.layers import BatchNorm, PReLU
from istnet_tpu_torch.nn.resnet_psp import ResNetTrunk

BATCH, NPOINTS, IMG, NCLASS = 32, 1024, 192, 6
SA_NPOINTS = (512, 256, 128, 64)


def make_inputs(b: int = BATCH, n: int = NPOINTS, img: int = IMG,
                seed: int = 0, device: str | torch.device = "cpu") -> dict:
    """The eval inputs of ``__graft_entry__._make_inputs(train=False)``."""
    rng = np.random.RandomState(seed)
    arrays = {
        "rgb": rng.rand(b, img, img, 3).astype(np.float32),
        "pts": rng.randn(b, n, 3).astype(np.float32) * 0.1,
        "choose": rng.randint(0, img * img, size=(b, n)).astype(np.int32),
        "category_label": rng.randint(0, NCLASS, size=(b,)).astype(np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default Conv/Linear init (kaiming-uniform a=sqrt(5): bound
    1/sqrt(fan_in), bias likewise), the trunk convs normal(0, sqrt(2/n))
    with n = kh*kw*out; every draw from ``generator``."""
    trunk_convs = {id(m) for t in model.modules() if isinstance(t, ResNetTrunk)
                   for m in t.modules() if isinstance(m, nn.Conv2d)}
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = m.weight
            if id(m) in trunk_convs:
                n = w.shape[0] * math.prod(w.shape[2:])
                w.normal_(0.0, math.sqrt(2.0 / n), generator=generator)
            else:
                bound = 1.0 / math.sqrt(w[0].numel())
                w.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(w[0].numel())
                m.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def perturb_eval_stats_(model: nn.Module, seed: int = 0) -> None:
    """Non-trivial BN running stats / affines and PReLU slopes."""
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            c = m.weight.numel()
            for t, v in ((m.running_mean, rng.randn(c) * 0.1),
                         (m.running_var, rng.uniform(0.5, 1.5, c)),
                         (m.weight, 1.0 + rng.randn(c) * 0.1),
                         (m.bias, rng.randn(c) * 0.1)):
                t.copy_(torch.from_numpy(v.astype(np.float32)))
        elif isinstance(m, PReLU):
            m.weight.fill_(float(rng.uniform(0.1, 0.4)))


def build_model(device: str | torch.device = "cpu", seed: int = 0,
                sa_npoints=SA_NPOINTS, nclass: int = NCLASS) -> ISTNet:
    """Full-width ``ISTNet`` in eval mode on ``device``, random weights
    made from ``seed``."""
    model = ISTNet(nclass=nclass, sa_npoints=sa_npoints)
    init_weights_(model, torch.Generator().manual_seed(seed))
    perturb_eval_stats_(model, seed)
    return model.eval().to(device)


def build_serving_model(dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device = "cpu", seed: int = 0,
                        sa_npoints=SA_NPOINTS) -> ISTNet:
    """``build_model`` under the compute policy ``dtype`` (bf16 by default,
    the deployment precision). The policy is global and read at every
    forward; ``precision.set_compute_dtype`` restores another one."""
    precision.set_compute_dtype(dtype)
    return build_model(device, seed, sa_npoints)
