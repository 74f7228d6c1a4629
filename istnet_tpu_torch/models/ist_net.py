"""IST-Net, eval forward (counterpart of ``istnet_tpu/models/ist_net.py``).

Inputs are a dict of tensors, channel-last as in the JAX package:

  rgb            (B, H, W, 3)   normalised crop (192 x 192 in production)
  pts            (B, N, 3)      camera-space points (metres)
  choose         (B, N)         flat pixel indices into the crop
  category_label (B,)           class id 0..nclass-1

Outputs: ``pred_rotation`` (B, 3, 3), ``pred_translation`` (B, 3),
``pred_size`` (B, 3), ``pred_qo`` (B, N, 3), all float32 under either
compute policy (``nn/precision.py``), as is the centroid ``c``.

Only the eval branch is ported; ``cam_enhancer`` and ``world_enhancer``
exist so that a full state dict loads strictly, and are not run.
"""

from __future__ import annotations

import torch
from torch import nn

from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.nn.estimators import (
    HeavyEstimator,
    ImplicitTransformation,
    LightEstimator,
)
from istnet_tpu_torch.nn.pointnet2_msg import PointNet2MSG
from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet

CAM_RADII = ((0.01, 0.02), (0.02, 0.04), (0.04, 0.08), (0.08, 0.16))
WORLD_RADII = ((0.05, 0.10), (0.10, 0.20), (0.20, 0.30), (0.30, 0.40))


def gather_by_choose(feat_map: torch.Tensor, choose: torch.Tensor
                     ) -> torch.Tensor:
    """(B, H, W, C), (B, N) -> (B, N, C) per-point pixel features."""
    b, h, w, c = feat_map.shape
    index = choose.long()[..., None].expand(-1, -1, c)
    return torch.gather(feat_map.reshape(b, h * w, c), 1, index)


class WorldSpaceEnhancer(nn.Module):
    """Train-only world-space extractor + pose head; not run at eval."""

    def __init__(self, sa_npoints):
        super().__init__()
        self.extractor = PointNet2MSG(WORLD_RADII, sa_npoints)
        self.pose_estimator = HeavyEstimator()


class ISTNet(nn.Module):
    """The IST-Net model. ``sparse_eval_head`` evaluates the encoder's last
    stage at the chosen pixels only (exact at eval)."""

    def __init__(self, nclass: int = 6,
                 sa_npoints=(512, 256, 128, 64),
                 sparse_eval_head: bool = True):
        super().__init__()
        self.sparse_eval_head = sparse_eval_head
        self.rgb_cam_extractor = ModifiedResnet()
        self.pts_cam_extractor = PointNet2MSG(CAM_RADII, sa_npoints)
        self.implicit_transform = ImplicitTransformation(nclass)
        self.main_estimator = HeavyEstimator()
        self.cam_enhancer = LightEstimator()
        self.world_enhancer = WorldSpaceEnhancer(sa_npoints)

    def forward(self, inputs: dict) -> dict:
        if self.training:
            raise NotImplementedError("the train branch is not ported yet; "
                                      "call .eval()")
        precision.apply_policy()
        rgb, pts, choose = inputs["rgb"], inputs["pts"], inputs["choose"]
        cls = inputs["category_label"].reshape(-1)

        c = pts.mean(dim=1, keepdim=True)
        pts = pts - c
        encoder = self.rgb_cam_extractor
        if self.sparse_eval_head:
            rgb_local = encoder.sparse_points(rgb, choose)
        else:
            rgb_local = gather_by_choose(encoder(rgb), choose)
        pts_local = self.pts_cam_extractor(pts)
        pts_w, pts_w_local = self.implicit_transform(rgb_local, pts_local,
                                                     pts, cls)
        r, t, s = self.main_estimator(pts, pts_w, rgb_local, pts_local,
                                      pts_w_local)
        return {"pred_qo": pts_w, "pred_rotation": r,
                "pred_translation": t + c.squeeze(1), "pred_size": s}
