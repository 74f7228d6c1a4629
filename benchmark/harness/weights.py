"""Weights from the seed, made on the device in two large draws.

The state dict has the reference model's names and shapes (those of the
published IST-Net), so the same dict loads into the reference and into
the program. Values follow torch's default layer init where the
published code keeps it: convs and linear layers uniform in
``+-1/sqrt(fan_in)`` (biases likewise), the ResNet trunk's convs
``normal(0, sqrt(2 / (k*k*out)))``; every BatchNorm gets non-trivial
running statistics and affines (mean ``0.1 N``, variance ``U(0.5, 1.5)``,
weight ``1 + 0.1 N``, bias ``0.1 N``) and every PReLU a slope ``U(0.1,
0.4)``, so that a skipped or swapped normalisation shows in the outputs.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference.model import BatchNorm, PReLU

TRUNK = "rgb_cam_extractor.model.feats."


def torch_seed(seed: int, stream: int = 0) -> int:
    """A 63-bit torch seed for one use of a run's ``--seed``."""
    return (seed * 1_000_003 + stream * 7_919) % (1 << 63)


def _plan(model: nn.Module):
    """(name, shape, rule, scale) for every floating leaf of the state."""
    out = []
    for mname, m in model.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = m.weight
            fan_in = w[0].numel()
            if pre.startswith(TRUNK) and isinstance(m, nn.Conv2d):
                out.append((pre + "weight", w.shape, "normal",
                            math.sqrt(2.0 / (w.shape[0] * math.prod(w.shape[2:])))))
            else:
                out.append((pre + "weight", w.shape, "uniform",
                            1.0 / math.sqrt(fan_in)))
            if m.bias is not None:
                out.append((pre + "bias", m.bias.shape, "uniform",
                            1.0 / math.sqrt(fan_in)))
        elif isinstance(m, BatchNorm):
            c = m.weight.shape
            out += [(pre + "running_mean", c, "normal", 0.1),
                    (pre + "running_var", c, "var", 0.0),
                    (pre + "weight", c, "one_plus", 0.1),
                    (pre + "bias", c, "normal", 0.1)]
        elif isinstance(m, PReLU):
            out.append((pre + "weight", m.weight.shape, "slope", 0.0))
    return out


@torch.no_grad()
def make_state_dict(model: nn.Module, seed: int,
                    device: torch.device) -> dict[str, torch.Tensor]:
    """The state dict of ``model``'s structure from ``seed`` on ``device``."""
    plan = _plan(model)
    sizes = [math.prod(shape) for _, shape, _, _ in plan]
    total = sum(sizes)
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, 1))
    uni = torch.rand(total, generator=gen, device=device)
    nrm = torch.randn(total, generator=gen, device=device)
    sd, at = {}, 0
    for (name, shape, rule, scale), n in zip(plan, sizes):
        u, z = uni[at:at + n], nrm[at:at + n]
        at += n
        if rule == "uniform":
            v = (2.0 * u - 1.0) * scale
        elif rule == "normal":
            v = z * scale
        elif rule == "one_plus":
            v = 1.0 + z * scale
        elif rule == "var":
            v = 0.5 + u
        else:                                   # PReLU slope
            v = 0.1 + 0.3 * u
        sd[name] = v.reshape(shape).clone()
    for name, buf in model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            sd[name] = torch.zeros((), dtype=torch.long, device=device)
        elif name not in sd:
            raise KeyError(f"make_state_dict: no rule for {name}")
    return sd


def build_on(cls, device: torch.device, *args, **kwargs) -> nn.Module:
    """``cls(*args, **kwargs)`` with its storage on ``device`` and no
    initialisation: the caller loads a state dict."""
    with torch.device("meta"):
        model = cls(*args, **kwargs)
    return model.to_empty(device=device)
