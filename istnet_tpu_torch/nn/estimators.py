"""Pose heads and the implicit space transformation.

Counterpart of ``istnet_tpu/nn/estimators.py``. Per-point MLPs are 1x1
``Conv1d`` chains applied on the last axis of ``(B, N, C)`` data (one matmul
each); the pose heads are ``Linear`` chains. Submodule names follow the
reference torch keys (``pts_mlp1.0``, ``rotation_estimator.4``, ...).

The MLPs run in the compute dtype (``nn/precision.py``); the pose heads'
last layers and the NOCS head return float32 (``istnet_tpu/nn/
estimators.py:49-55, :82``), and the rotation is orthonormalised in
float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from istnet_tpu_torch.nn.layers import pointwise
from istnet_tpu_torch.nn.rotation import ortho6d_to_mat


class MLP(nn.Sequential):
    """``Conv1d(1x1)`` (or ``Linear``) + ReLU chain over the last axis; with
    ``final_act=False`` the last layer is linear."""

    def __init__(self, cin: int, channels: Sequence[int],
                 final_act: bool = True, linear: bool = False):
        layers: list[nn.Module] = []
        for i, c in enumerate(channels):
            layers.append(nn.Linear(cin, c) if linear else nn.Conv1d(cin, c, 1))
            if final_act or i + 1 < len(channels):
                layers.append(nn.ReLU())
            cin = c
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for m in self:
            x = F.relu(x) if isinstance(m, nn.ReLU) else pointwise(x, m)
        return x


class PoseHeads(nn.Module):
    """rot-6D / translation / size heads on a 512-d global feature."""

    def __init__(self):
        super().__init__()
        self.rotation_estimator = MLP(512, (512, 256, 6), False, linear=True)
        self.translation_estimator = MLP(512, (512, 256, 3), False, linear=True)
        self.size_estimator = MLP(512, (512, 256, 3), False, linear=True)

    def heads(self, feat: torch.Tensor):
        r6 = self.rotation_estimator(feat).float()
        r = ortho6d_to_mat(r6[:, :3], r6[:, 3:])
        return (r, self.translation_estimator(feat).float(),
                self.size_estimator(feat).float())


def _with_global_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.mean(dim=1, keepdim=True).expand_as(x)], dim=-1)


class FeatureDeformer(nn.Module):
    """Implicit space transformation: world-space features and per-class
    NOCS coordinates, the sample's class selected."""

    def __init__(self, nclass: int = 6):
        super().__init__()
        self.nclass = nclass
        self.pts_mlp1 = MLP(3, (32, 64))
        self.deform_mlp1 = MLP(320, (384, 256))
        self.deform_mlp2 = MLP(512, (384, 256, 128))
        self.pred_nocs = MLP(128, (256, 128, nclass * 3), final_act=False)

    def forward(self, pts, rgb_local, pts_local, cls):
        b, n, _ = pts.shape
        deform = torch.cat([self.pts_mlp1(pts), pts_local, rgb_local], dim=-1)
        pts_local_w = self.deform_mlp2(_with_global_mean(self.deform_mlp1(deform)))
        nocs = self.pred_nocs(pts_local_w).float().reshape(b, n, self.nclass, 3)
        pts_w = nocs[torch.arange(b, device=cls.device), :, cls.long()]
        return pts_local_w, pts_w


class ImplicitTransformation(nn.Module):
    def __init__(self, nclass: int = 6):
        super().__init__()
        self.feature_refine = FeatureDeformer(nclass)

    def forward(self, rgb_local, pts_local, pts, cls):
        pts_local_w, pts_w = self.feature_refine(pts, rgb_local, pts_local, cls)
        return pts_w, pts_local_w


class LightEstimator(PoseHeads):
    """Train-only auxiliary camera-space pose head (``cam_enhancer``)."""

    def __init__(self):
        super().__init__()
        self.pts_mlp = MLP(3, (32, 64))
        self.pose_mlp1 = MLP(320, (256, 256))
        self.pose_mlp2 = MLP(512, (512, 512))

    def forward(self, pts, rgb_local, pts_local):
        feat = torch.cat([rgb_local, self.pts_mlp(pts), pts_local], dim=-1)
        feat = self.pose_mlp2(_with_global_mean(self.pose_mlp1(feat)))
        return self.heads(feat.mean(dim=1))


class HeavyEstimator(PoseHeads):
    """Main pose head."""

    def __init__(self):
        super().__init__()
        self.pts_mlp1 = MLP(3, (32, 64))
        self.pts_mlp2 = MLP(3, (32, 64))
        self.pose_mlp1 = MLP(512, (256, 256))
        self.pose_mlp2 = MLP(512, (512, 512))

    def forward(self, pts, pts_w, rgb_local, pts_local, pts_w_local):
        feat = torch.cat([rgb_local, self.pts_mlp1(pts), pts_local,
                          self.pts_mlp2(pts_w), pts_w_local], dim=-1)
        feat = self.pose_mlp2(_with_global_mean(self.pose_mlp1(feat)))
        return self.heads(feat.mean(dim=1))
