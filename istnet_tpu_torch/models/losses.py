"""Loss primitives (counterpart of ``istnet_tpu/models/losses.py``), with the
JAX package's dtypes: the point and feature losses accumulate in float32;
``pose_dis`` keeps its inputs' dtype."""

from __future__ import annotations

import torch


def smooth_l1_dis(p1: torch.Tensor, p2: torch.Tensor,
                  threshold: float = 0.1) -> torch.Tensor:
    """Per-coordinate smooth L1, summed over xyz, mean over batch*points."""
    diff = torch.abs(p1.float() - p2.float())
    less = torch.square(diff) / (2.0 * threshold)
    higher = diff - threshold / 2.0
    return torch.where(diff > threshold, higher, less).sum(dim=-1).mean()


def chamfer_dis(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer distance of (B, N, 3) and (B, M, 3) point sets
    (``losses.py:25-34``): each point's distance to its nearest neighbour
    in the other set, averaged a set and a sample, the two halves weighted
    0.5. Part of the reference's loss module; IST-Net does not use it."""
    dis = torch.linalg.vector_norm(p1[:, :, None, :] - p2[:, None, :, :],
                                   dim=-1)
    dis1 = dis.amin(dim=2)
    dis2 = dis.amin(dim=1)
    return torch.mean(0.5 * dis1.mean(dim=1) + 0.5 * dis2.mean(dim=1))


def norm_zero_subgrad(d: torch.Tensor, dim: int) -> torch.Tensor:
    """L2 norm over ``dim`` whose gradient at an exactly zero vector is 0,
    not NaN (``losses.py:_norm_zero_subgrad``): the double ``where`` keeps
    ``sqrt`` off 0 in the backward. A converged run can reach an exact-zero
    pose difference."""
    sq = torch.sum(torch.square(d), dim=dim)
    positive = sq > 0
    return torch.where(positive, torch.sqrt(torch.where(positive, sq, 1.0)),
                       0.0)


def pose_dis(r1, t1, s1, r2, t2, s2) -> torch.Tensor:
    """Mean column norm of the rotation difference (norm over the rows)
    plus the mean norms of the translation and size differences."""
    return (norm_zero_subgrad(r1 - r2, 1).mean()
            + norm_zero_subgrad(t1 - t2, 1).mean()
            + norm_zero_subgrad(s1 - s2, 1).mean())


def feature_mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``mse_loss`` accumulated in float32."""
    return torch.mean(torch.square(a.float() - b.float()))
