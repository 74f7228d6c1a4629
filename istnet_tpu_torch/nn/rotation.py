"""6D rotation representation -> rotation matrix (counterpart of
``istnet_tpu/nn/rotation.py``; Gram-Schmidt by cross products)."""

from __future__ import annotations

import torch


def normalize_vector(v: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    mag = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(mag, min=eps)


def ortho6d_to_mat(x_raw: torch.Tensor, y_raw: torch.Tensor) -> torch.Tensor:
    """(..., 3), (..., 3) -> (..., 3, 3) with columns [x, y, z]:
    y = norm(y_raw); z = norm(x_raw x y); x = y x z."""
    y = normalize_vector(y_raw)
    z = normalize_vector(torch.linalg.cross(x_raw, y, dim=-1))
    x = torch.linalg.cross(y, z, dim=-1)
    return torch.stack([x, y, z], dim=-1)
