"""Point-cloud set operations of PointNet++ in plain PyTorch: the
reference's FPS, ball query, grouping and 3-NN interpolation.

Their contracts are those of the CUDA operators IST-Net was published
with (``pointnet2_ops``), in the form whose every decision is exact:

- ``furthest_point_sample``: start at index 0; the running minimum of the
  squared distance seeded with 1e10; distances by direct differences;
  argmax ties to the lowest index.
- ``ball_query``: the first ``nsample`` points with ``d2 < r^2`` in index
  order, padded with the first hit; point 0 where nothing hits.
- ``three_nn``: the 3 smallest ``d2`` in (d2, index) order; distances
  ``sqrt(d2)``; weights ``1 / (d + 1e-8)`` normalised over the three.

Distances between two sets are ``(|a|^2 + |b|^2) - 2 a.b``, each term
written out in a fixed order, clamped at 0, in float32; radii are
compared with ``float32(r) ** 2``. Layout is channel-last: points
``(B, N, 3)``, features ``(B, N, C)``. Indices carry no gradient; the
grouping is differentiable in points, centroids and features, the
interpolation in the features.
"""

from __future__ import annotations

import numpy as np
import torch


def _norm2(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    return x * x + y * y + z * z


def pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(B, M, 3), (B, N, 3) -> (B, M, N)`` squared distances."""
    a, b = a.float(), b.float()
    ax, ay, az = (t[:, :, None] for t in a.unbind(-1))
    bx, by, bz = (t[:, None, :] for t in b.unbind(-1))
    ab = ax * bx + ay * by + az * bz
    d2 = (_norm2(a)[:, :, None] + _norm2(b)[:, None, :]) - 2.0 * ab
    return torch.clamp(d2, min=0.0)


def radius_sq(radius: float) -> float:
    r = np.float32(radius)
    return float(r * r)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """``(B, N, 3) -> (B, npoint)`` int64 indices."""
    b, n, _ = xyz.shape
    xyz = xyz.detach().float()
    x, y, z = xyz.unbind(-1)
    rows = torch.arange(b, device=xyz.device)
    lane = torch.arange(n, device=xyz.device)
    out = torch.zeros(b, npoint, dtype=torch.long, device=xyz.device)
    min_d2 = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, last]
        dx, dy, dz = x - p[:, 0:1], y - p[:, 1:2], z - p[:, 2:3]
        min_d2 = torch.minimum(min_d2, dx * dx + dy * dy + dz * dz)
        top = min_d2.max(dim=1, keepdim=True).values
        last = torch.where(min_d2 == top, lane, n).min(dim=1).values
        out[:, j] = last
    return out


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(B, N, C), (B, M) -> (B, M, C)``."""
    index = idx.long()[..., None].expand(-1, -1, points.shape[-1])
    return torch.gather(points, 1, index)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(B, N, C), (B, M, S) -> (B, M, S, C)``."""
    b, m, s = idx.shape
    return gather_points(points, idx.reshape(b, m * s)).reshape(
        b, m, s, points.shape[-1])


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """``(B, N, 3), (B, M, 3) -> (B, M, nsample)`` int64 indices."""
    hit = pairwise_d2(new_xyz.detach(), xyz.detach()) < radius_sq(radius)
    b, m, n = hit.shape
    rank = torch.cumsum(hit, dim=-1) - 1
    slot = torch.where(hit & (rank < nsample), rank, nsample)
    src = torch.arange(n, dtype=torch.long, device=hit.device).expand(b, m, n)
    out = torch.full((b, m, nsample + 1), -1, dtype=torch.long,
                     device=hit.device)
    out.scatter_(2, slot, src)             # slot ``nsample`` takes the misses
    out = out[..., :nsample]
    first = torch.clamp(out[..., :1], min=0)
    return torch.where(out >= 0, out, first)


def ball_query_group(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     features: torch.Tensor | None) -> torch.Tensor:
    """``(B, M, nsample, 3 + C)``: ``[xyz[idx] - centroid, features[idx]]``."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if features is not None:
        grouped = torch.cat([grouped, group_points(features, idx)], dim=-1)
    return grouped


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """``(B, N, 3), (B, M, 3) -> dist (B, N, 3), idx (B, N, 3)``."""
    d2 = pairwise_d2(unknown.detach(), known.detach())
    m = d2.shape[-1]
    lane = torch.arange(m, device=d2.device)
    dists, idxs = [], []
    for _ in range(3):
        mn = d2.min(dim=-1, keepdim=True).values
        sel = torch.where(d2 == mn, lane, m).min(dim=-1, keepdim=True).values
        d2 = torch.where(lane == sel, torch.inf, d2)
        dists.append(mn)
        idxs.append(sel)
    return torch.sqrt(torch.cat(dists, dim=-1)), torch.cat(idxs, dim=-1)


def three_interpolate(unknown: torch.Tensor, known: torch.Tensor,
                      feats: torch.Tensor) -> torch.Tensor:
    """``(B, N, 3), (B, M, 3), (B, M, C) -> (B, N, C)``: inverse-distance
    weighted sum of the 3 nearest known points' features."""
    dist, idx = three_nn(unknown, known)
    recip = 1.0 / (dist + 1e-8)
    weight = recip / torch.sum(recip, dim=-1, keepdim=True)
    return torch.sum(group_points(feats, idx) * weight[..., None], dim=2)
