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

A Bottleneck trunk (ResNet-50/101/152) has the weight and bias of the last
BatchNorm of each residual branch (``bn3``) drawn so and then scaled by
``BRANCH_END``, 0.35. Measured on the reference's ResNet-101 trunk at
96 x 96, B=2, crops of uniform RGB (weight seed 7): as drawn, the sum
grows block by block and the output's RMS reaches 8.4e5 (ResNet-18: 3.6);
scaled by 0.25 it is 0.87, by 0.35 3.9, by 0.5 56. At 0.35 float32 and
bfloat16 drift from a float64 forward as ResNet-18's do (1.3e-5 max over
RMS against 1.2e-5; 0.0071 RMS over RMS against 0.0079), and skipping the
branch of ``layer3[11]`` moves the encoder's output by 19 times its
bfloat16 drift. No forward pass goes into making the weights: calibrating
every BatchNorm from a seeded batch leaves ResNet-101 chaotic (bfloat16
drift near 0.9 of the RMS). The BasicBlock trunks (ResNet-18/34) have no
``bn3``: their weights are as drawn.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference.model import BatchNorm, Bottleneck, PReLU

TRUNK = "rgb_cam_extractor.model.feats."
#: the scale of each Bottleneck branch's last BatchNorm affine
BRANCH_END = 0.35


def torch_seed(seed: int, stream: int = 0) -> int:
    """A 63-bit torch seed for one use of a run's ``--seed``."""
    return (seed * 1_000_003 + stream * 7_919) % (1 << 63)


def _branch_ends(model: nn.Module) -> set[str]:
    """The names of the affine leaves that ``BRANCH_END`` scales: the
    weight and bias of each Bottleneck's ``bn3``."""
    return {f"{name}.bn3.{leaf}" for name, m in model.named_modules()
            if isinstance(m, Bottleneck) for leaf in ("weight", "bias")}


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
    ends = _branch_ends(model)
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
        if name in ends:
            v = v * BRANCH_END
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
