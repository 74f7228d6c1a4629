"""Point-cloud set ops in plain PyTorch: the plain versions of the kernels.

Counterpart of ``istnet_tpu/ops/pointnet2.py`` with the contracts that
``istnet_tpu/ops/golden.py`` and the JAX tests pin:

- ``furthest_point_sample``: start at index 0; running min of d2 seeded with
  1e10; d2 by direct differences; argmax ties to the lowest index.
- ``ball_query``: the first ``nsample`` points with ``d2 < r^2`` in index
  order, padded with the first hit; point 0 everywhere when nothing hits.
- ``three_nn``: the 3 smallest d2 in (d2, index) order, i.e. a strict ``<``
  scan; distances are ``sqrt(max(d2, 0))``.

Distances between two sets use the JAX form ``|a|^2 + |b|^2 - 2 a.b``
(``pairwise_d2``), every term written out elementwise in a fixed order so
that the CUDA kernels, which evaluate the same order without FMA
contraction, decide every radius test and 3-NN tie exactly as these do.
All indices are int32, as in the JAX package. Layout is channel-last:
points ``(B, N, 3)``, features ``(B, N, C)``.

Gradients. No index or distance carries one: FPS, the radius tests and
the 3-NN choice are decisions, and ``fp_interpolate`` detaches its
distances (``istnet_tpu/ops/dispatch.py:68-69``), so points that are their
own SA centre (distance exactly 0) give no NaN through ``sqrt``. Values do:
``ball_query_group`` is differentiable in the points, centroids and
features, ``fp_interpolate`` in the features only. ``group_scatter`` and
``three_interpolate_grad`` are the transposes the backward kernels compute.

float64 inputs (the parity tests' policy) keep float64 values, as JAX's
x64 path does; the decisions stay float32, except that ``three_nn``
decides on direct float64 differences there, as JAX's does
(``istnet_tpu/ops/pointnet2.py:201-207``).
"""

from __future__ import annotations

import numpy as np
import torch


def _norm2(p: torch.Tensor) -> torch.Tensor:
    """``(x*x + y*y) + z*z`` over the last axis of ``(..., 3)``."""
    x, y, z = p.unbind(-1)
    return x * x + y * y + z * z


def pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(B, M, 3), (B, N, 3) -> (B, M, N)``: ``(|a|^2 + |b|^2) - 2 a.b``
    clamped at 0 (``istnet_tpu/ops/pointnet2.py:82-97``)."""
    a = a.float()
    b = b.float()
    ax, ay, az = (t[:, :, None] for t in a.unbind(-1))
    bx, by, bz = (t[:, None, :] for t in b.unbind(-1))
    ab = ax * bx + ay * by + az * bz
    d2 = (_norm2(a)[:, :, None] + _norm2(b)[:, None, :]) - 2.0 * ab
    return torch.clamp(d2, min=0.0)


def radius_sq(radius: float) -> float:
    """``r^2`` rounded as JAX rounds ``jnp.float32(radius) ** 2``."""
    r = np.float32(radius)
    return float(r * r)


# ---------------------------------------------------------------------------
# Furthest point sampling
# ---------------------------------------------------------------------------

def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """``(B, N, 3) -> (B, npoint)`` int32 farthest-point indices."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    x, y, z = xyz.unbind(-1)
    rows = torch.arange(b, device=xyz.device)
    lane = torch.arange(n, device=xyz.device)
    out = torch.zeros(b, npoint, dtype=torch.int32, device=xyz.device)
    min_d2 = torch.full((b, n), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(b, dtype=torch.long, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, last]                                   # (B, 3)
        dx = x - p[:, 0:1]
        dy = y - p[:, 1:2]
        dz = z - p[:, 2:3]
        min_d2 = torch.minimum(min_d2, dx * dx + dy * dy + dz * dz)
        top = min_d2.max(dim=1, keepdim=True).values
        last = torch.where(min_d2 == top, lane, n).min(dim=1).values
        out[:, j] = last.to(torch.int32)
    return out


# ---------------------------------------------------------------------------
# Gathers
# ---------------------------------------------------------------------------

def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(B, N, C), (B, M) -> (B, M, C)``."""
    c = points.shape[-1]
    index = idx.long()[..., None].expand(-1, -1, c)
    return torch.gather(points, 1, index)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``(B, N, C), (B, M, S) -> (B, M, S, C)``."""
    b, m, s = idx.shape
    return gather_points(points, idx.reshape(b, m * s)).reshape(
        b, m, s, points.shape[-1])


# ---------------------------------------------------------------------------
# Ball query
# ---------------------------------------------------------------------------

def _first_hits(hit: torch.Tensor, nsample: int) -> torch.Tensor:
    """``(B, M, N)`` hit mask -> ``(B, M, nsample)`` int32: the first
    ``nsample`` hit indices in index order, padded with the first hit, all
    0 on a row without hits. Each hit's slot is its exclusive hit count."""
    b, m, n = hit.shape
    rank = torch.cumsum(hit, dim=-1) - 1
    slot = torch.where(hit & (rank < nsample), rank, nsample)
    src = torch.arange(n, dtype=torch.long, device=hit.device).expand(b, m, n)
    out = torch.full((b, m, nsample + 1), -1, dtype=torch.long,
                     device=hit.device)
    out.scatter_(2, slot, src)            # slot ``nsample`` collects misses
    out = out[..., :nsample]
    pad = torch.clamp(out[..., :1], min=0)
    return torch.where(out >= 0, out, pad).to(torch.int32)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """``(B, N, 3), (B, M, 3) -> (B, M, nsample)`` int32 neighbour indices."""
    hit = pairwise_d2(new_xyz, xyz) < radius_sq(radius)
    return _first_hits(hit, nsample)


def ball_query_multi(radii, nsamples, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> list:
    """Per radius ``(B, M, ns)`` int32 neighbour indices over one distance
    pass, the plain version of the ``ops/ball_query.py`` kernel
    (``istnet_tpu/ops/ball_query_pallas.py:ball_query_multi_pallas``)."""
    d2 = pairwise_d2(new_xyz.detach(), xyz.detach())
    return [_first_hits(d2 < radius_sq(r), ns) for r, ns in zip(radii, nsamples)]


def _value_dtype(t: torch.Tensor) -> torch.dtype:
    """float64 stays float64; every other dtype computes in float32."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def ball_query_group(radii, nsamples, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     features: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.float32) -> list:
    """Multi-radius ball query + grouping, the plain version of the
    ``ops/ball_query_group.py`` kernel: per radius ``(B, M, ns, 3 + C)`` =
    ``[xyz[idx] - centroid, features[idx]]``, formed in float32 and rounded
    once to ``out_dtype`` (``istnet_tpu/ops/dispatch.py:92``). One distance
    pass serves all radii."""
    dt = _value_dtype(xyz)
    xyz, new_xyz = xyz.to(dt), new_xyz.to(dt)
    outs = []
    for idx in ball_query_multi(radii, nsamples, xyz, new_xyz):
        grouped = group_points(xyz, idx) - new_xyz[:, :, None, :]
        if features is not None:
            grouped = torch.cat([grouped, group_points(features.to(dt), idx)],
                                dim=-1)
        outs.append(grouped.to(out_dtype))
    return outs


def group_points_grad(grad: torch.Tensor, idx: torch.Tensor,
                      n: int) -> torch.Tensor:
    """The transpose of ``group_points``: ``(B, M, S, C), (B, M, S) ->
    (B, N, C)``, each slot's row added into the point it holds."""
    b, m, s, c = grad.shape
    out = torch.zeros(b, n, c, dtype=grad.dtype, device=grad.device)
    index = idx.long().reshape(b, m * s, 1).expand(-1, -1, c)
    return out.scatter_add_(1, index, grad.reshape(b, m * s, c))


def group_scatter(idx_list, grads, n: int):
    """The backward of ``ball_query_group`` past its indices, the plain
    version of the ``ops/group_scatter.py`` kernel
    (``istnet_tpu/ops/ball_query_pallas.py:_bqg_bwd``). Per radius ``idx``
    ``(B, M, ns)`` and the cotangent ``(B, M, ns, 3 + C)`` of its grouped
    tensor -> ``points_bar (B, N, 3 + C)``, every slot's cotangent added
    into its point (pad slots into the first hit, rows without a hit into
    point 0; ``[..., :3]`` is the points' gradient, ``[..., 3:]`` the
    features'), and ``centroid_bar (B, M, 3)``, minus the slot sum of the
    relative-xyz cotangents, all in float32."""
    points_bar = sum(group_points_grad(g.float(), idx, n)
                     for idx, g in zip(idx_list, grads))
    centroid_bar = -sum(g[..., :3].float().sum(dim=2) for g in grads)
    return points_bar, centroid_bar


# ---------------------------------------------------------------------------
# Three-NN interpolation
# ---------------------------------------------------------------------------

def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """``(B, N, 3), (B, M, 3) -> dist (B, N, 3), idx (B, N, 3) int32``: the
    3 nearest known points by (d2, index), ``dist = sqrt(d2)``. The plain
    version of the ``ops/three_nn.py`` kernel."""
    if unknown.dtype == torch.float64:
        d2 = ((unknown[:, :, None, :] - known[:, None, :, :]) ** 2).sum(-1)
    else:
        d2 = pairwise_d2(unknown, known)                  # (B, N, M)
    m = d2.shape[-1]
    lane = torch.arange(m, device=d2.device)
    dists, idxs = [], []
    for _ in range(3):
        mn = d2.min(dim=-1, keepdim=True).values
        sel = torch.where(d2 == mn, lane, m).min(dim=-1, keepdim=True).values
        d2 = torch.where(lane == sel, torch.inf, d2)
        dists.append(mn)
        idxs.append(sel)
    dist = torch.sqrt(torch.cat(dists, dim=-1))
    return dist, torch.cat(idxs, dim=-1).to(torch.int32)


def three_interpolate_weights(dist: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weights ``1/(d + 1e-8)``, normalised over the 3."""
    recip = 1.0 / (dist + 1e-8)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def three_interpolate(points: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """``(B, M, C), (B, N, 3), (B, N, 3) -> (B, N, C)`` weighted sum."""
    return torch.sum(group_points(points, idx) * weight[..., None], dim=2)


def three_interpolate_grad(grad: torch.Tensor, idx: torch.Tensor,
                           weight: torch.Tensor, m: int) -> torch.Tensor:
    """The transpose of ``three_interpolate`` in its points, the plain
    version of the ``ops/interp_scatter.py`` kernel: ``(B, N, C), (B, N,
    3), (B, N, 3) -> (B, M, C)``, ``weight[n, k] * grad[n]`` added into
    known point ``idx[n, k]``, in float32
    (``istnet_tpu/ops/three_nn_pallas.py:_fpi_bwd``)."""
    b, n, c = grad.shape
    rows = (weight.float()[..., None] * grad.float()[:, :, None, :])
    out = torch.zeros(b, m, c, dtype=torch.float32, device=grad.device)
    index = idx.long().reshape(b, n * 3, 1).expand(-1, -1, c)
    return out.scatter_add_(1, index, rows.reshape(b, n * 3, c))


def fp_interpolate(unknown: torch.Tensor, known: torch.Tensor,
                   feats: torch.Tensor) -> torch.Tensor:
    """The whole FP gather stage, the plain version of the
    ``ops/fp_interpolate.py`` kernel: 3-NN, inverse-distance weights and
    their weighted sum of ``feats``. ``(B, N, 3), (B, M, 3), (B, M, C) ->
    (B, N, C)`` in the dtype of ``feats``.

    bf16 features follow the TPU kernel (``three_nn_pallas.py:134-147``):
    float32 weights, a float32 sum and one rounding to bf16. (JAX's XLA
    path rounds the weights to bf16 first; that path is not the contract.)
    The gradient flows into ``feats`` only.
    """
    dist, idx = three_nn(unknown.detach(), known.detach())
    out = three_interpolate(feats.to(_value_dtype(feats)), idx,
                            three_interpolate_weights(dist))
    return out.to(feats.dtype)
