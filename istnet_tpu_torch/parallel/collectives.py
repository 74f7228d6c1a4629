"""Collectives of the data-parallel step (XLA's ``psum`` in the JAX
package, inserted by GSPMD).

``all_reduce_sum`` is differentiable: the sum over ranks in the forward and,
since every rank's loss reads the sum, the sum of the cotangents over ranks
in the backward; the global-batch BatchNorm (``nn/layers.py``) reduces its
statistics through it. Written here rather than taken from
``torch.distributed.nn.functional``, which recent torch marks deprecated.
``all_reduce_mean`` is for metrics, without a graph.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (the default group if
    None), on every rank, differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` averaged over the ranks of ``group``, without a graph; ``x``
    itself without a process group."""
    if not dist.is_initialized():
        return x
    y = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, group=group)
    return y / dist.get_world_size(group)
