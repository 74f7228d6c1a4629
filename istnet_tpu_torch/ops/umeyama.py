"""Umeyama similarity fit and RANSAC, batched, on the card or the CPU.

The port of ``istnet_tpu/ops/umeyama.py`` (the reference's
``utils/align.py:10-101``, itself from NOCS_CVPR2019):

- ``umeyama``: the weighted similarity ``(s, R, t)`` fit by SVD, batched
  over leading dimensions, float32 as in JAX: the target-major covariance
  ``centred_target^T diag(w) centred_source``, the det sign fix on
  ``d[-1]`` and ``u[:, -1]``, ``s = sum(d) / var(source)``, ``t = mu_t -
  s R mu_s``. Weights generalise the reference's subset refit: the fit on
  an inlier mask is the weighted fit.
- ``score_hypotheses``: every 5-point hypothesis of given indices fitted
  in one batched SVD and scored at once (inlier threshold ``s *
  diameter(source) / 10``), the first best inlier ratio taken and the fit
  redone with its inlier mask as weights; ``valid`` is ``ratio >= 0.1``.
- ``ransac_similarity``: ``score_hypotheses`` on ``(max_iter, 5)``
  indices drawn from an explicit ``torch.Generator`` on the points'
  device. JAX draws other indices from its key; both fits converge on
  the all-inlier refit where the data allow it.

``torch.linalg.svd`` runs cuSOLVER's batched solver on the card and LAPACK
on the CPU; the det fix makes ``R`` unique for distinct singular values.
"""

from __future__ import annotations

import numpy as np
import torch


def umeyama(source: torch.Tensor, target: torch.Tensor,
            weights: torch.Tensor | None = None):
    """Weighted similarity fit, ``target ~= s R source + t``.

    ``source``, ``target``: ``(..., N, 3)``; ``weights``: ``(..., N)``
    nonnegative, ``None`` uniform. Returns ``(scale (...), rotation (...,
    3, 3), translation (..., 3), transform (..., 4, 4))``, float32."""
    source = source.float()
    target = target.float()
    if weights is None:
        weights = torch.ones(source.shape[:-1], dtype=torch.float32,
                             device=source.device)
    weights = weights.float()
    w = (weights / weights.sum(-1, keepdim=True).clamp(min=1e-12))[..., None]
    mu_s = (source * w).sum(-2)
    mu_t = (target * w).sum(-2)
    cs = source - mu_s[..., None, :]
    ct = target - mu_t[..., None, :]
    cov = (ct * w).transpose(-1, -2) @ cs           # (..., 3, 3) target-major

    u, d, vh = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(u) * torch.linalg.det(vh))
    d = torch.cat([d[..., :-1], d[..., -1:] * sign[..., None]], -1)
    u = torch.cat([u[..., :-1], u[..., -1:] * sign[..., None, None]], -1)
    rotation = u @ vh

    var_s = (cs * cs * w).sum(-2).sum(-1)
    scale = d.sum(-1) / var_s.clamp(min=1e-12)
    translation = (mu_t
                   - scale[..., None] * (rotation @ mu_s[..., None])[..., 0])

    transform = torch.zeros(scale.shape + (4, 4), dtype=torch.float32,
                            device=source.device)
    transform[..., :3, :3] = scale[..., None, None] * rotation
    transform[..., :3, 3] = translation
    transform[..., 3, 3] = 1.0
    return scale, rotation, translation, transform


def score_hypotheses(source: torch.Tensor, target: torch.Tensor,
                     idx: torch.Tensor) -> dict:
    """RANSAC on given hypotheses: ``idx`` ``(..., H, 5)`` point indices
    into ``source`` / ``target`` ``(..., N, 3)``.

    Returns ``{scale, rotation, translation, transform}`` of the refit on
    the best hypothesis's inliers, ``inlier_ratio`` and ``valid`` (ratio
    >= 0.1), and every hypothesis's ``ratios`` ``(..., H)`` and the best
    one's ``inlier_mask`` ``(..., N)``."""
    source = source.float()
    target = target.float()
    diameter = 2.0 * torch.linalg.vector_norm(
        source - source.mean(-2, keepdim=True), dim=-1).amax(-1)
    inlier_t = diameter / 10.0                                  # (...)

    flat = idx.long().flatten(-2)[..., None].expand(*idx.shape[:-2], -1, 3)

    def pick(x):                            # (..., N, 3) -> (..., H, 5, 3)
        return torch.gather(x, -2, flat).unflatten(-2, idx.shape[-2:])

    s, r, t, _ = umeyama(pick(source), pick(target))           # (..., H)
    moved = source[..., None, :, :] @ (s[..., None, None] * r).transpose(
        -1, -2) + t[..., None, :]                              # (..., H, N, 3)
    resid = torch.linalg.vector_norm(target[..., None, :, :] - moved, dim=-1)
    inliers = resid < (s * inlier_t[..., None])[..., None]     # (..., H, N)
    # JAX's mean: the count times the float32 reciprocal of N
    ratios = inliers.sum(-1).float() * torch.tensor(
        1.0 / inliers.shape[-1], dtype=torch.float32, device=source.device)

    best = torch.argmax(ratios, dim=-1, keepdim=True)          # first best
    ratio = torch.gather(ratios, -1, best)[..., 0]
    mask = torch.gather(inliers, -2, best[..., None].expand(
        *best.shape[:-1], 1, inliers.shape[-1]))[..., 0, :].float()
    scale, rotation, translation, transform = umeyama(source, target, mask)
    return {"scale": scale, "rotation": rotation, "translation": translation,
            "transform": transform, "inlier_ratio": ratio,
            "valid": ratio >= 0.1, "ratios": ratios, "inlier_mask": mask}


def ransac_similarity(source: torch.Tensor, target: torch.Tensor,
                      generator: torch.Generator, max_iter: int = 128
                      ) -> dict:
    """RANSAC similarity fit of ``(..., N, 3)`` correspondences, every
    hypothesis at once; the draws come from ``generator``, which lies on
    the points' device. Returns ``score_hypotheses``'s dict."""
    if generator.device.type != source.device.type:
        raise ValueError(f"the generator lies on {generator.device}, the "
                         f"points on {source.device}")
    idx = torch.randint(0, source.shape[-2],
                        (*source.shape[:-2], max_iter, 5),
                        generator=generator, device=source.device)
    return score_hypotheses(source, target, idx)


def estimate_similarity_transform(source, target, seed: int = 0,
                                  max_iter: int = 128,
                                  device: str | torch.device = "cuda"):
    """numpy in and out, the reference's API (``align.py:44-101``): the fit
    of ``(N, 3)`` arrays on ``device`` (the card unless asked for the
    CPU), draws from a generator seeded ``seed``. Returns ``(scale,
    rotation, translation, transform)``, or ``(None,) * 4`` where the fit
    is degenerate (inlier ratio below 0.1), as JAX's does."""
    from istnet_tpu_torch.entry import on_device
    device = on_device(device, "estimate_similarity_transform")
    src = torch.as_tensor(np.asarray(source, np.float32), device=device)
    tgt = torch.as_tensor(np.asarray(target, np.float32), device=device)
    generator = torch.Generator(device=device).manual_seed(seed)
    out = ransac_similarity(src, tgt, generator, max_iter)
    if not bool(out["valid"]):
        return None, None, None, None
    return (float(out["scale"]), out["rotation"].cpu().numpy(),
            out["translation"].cpu().numpy(), out["transform"].cpu().numpy())
