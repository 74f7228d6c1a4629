"""PoseNetGT, the two-phase recipe's first model, and its loss (counterpart
of ``istnet_tpu/models/posenet_gt.py``).

ResNet+PSP RGB features (``rgb_extractor``) and a camera-space PointNet2MSG
(``pts_extractor``) give per-point features that the pose head takes
detached; a world-space PointNet2MSG over the ground-truth NOCS points
(``pts_gt_extractor``) feeds the head with gradient. Phase 2 moves that
extractor into IST-Net's ``world_enhancer.extractor``
(``train/checkpoints.py::load_world_enhancer``). The submodules carry the
reference torch key names, so a reference ``.pth`` loads strictly.

The detached branches run without a graph: nothing trains them (Adam skips
their parameters, whose ``.grad`` stays None), while their train-mode BNs
still publish batch statistics for the step's EMA, as in JAX.
"""

from __future__ import annotations

import torch
from torch import nn

from istnet_tpu_torch.models import losses
from istnet_tpu_torch.models.ist_net import CAM_RADII, WORLD_RADII, gather_by_choose
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.nn.estimators import HeavyEstimator
from istnet_tpu_torch.nn.pointnet2_msg import PointNet2MSG
from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet


class PoseNetGT(nn.Module):
    """Inputs as ``ISTNet``'s (``rgb``, ``pts``, ``choose``, ``qo``);
    outputs ``pts_local_w_gt`` (B, N, 128) and the pose
    ``pred_rotation`` / ``pred_translation`` / ``pred_size``. ``nclass``
    is kept for the JAX signature; the model does not read it."""

    def __init__(self, nclass: int = 6, sa_npoints=(512, 256, 128, 64)):
        super().__init__()
        self.nclass = nclass
        self.rgb_extractor = ModifiedResnet()
        self.pts_extractor = PointNet2MSG(CAM_RADII, sa_npoints)
        self.pts_gt_extractor = PointNet2MSG(WORLD_RADII, sa_npoints)
        self.pose_estimator_aux = HeavyEstimator()

    def forward(self, inputs: dict,
                generator: torch.Generator | None = None) -> dict:
        precision.apply_policy()
        rgb, pts, choose = inputs["rgb"], inputs["pts"], inputs["choose"]
        pts_w_gt = inputs["qo"]

        c = pts.mean(dim=1, keepdim=True)
        pts = pts - c
        with torch.no_grad():
            rgb_local = gather_by_choose(self.rgb_extractor(rgb, generator),
                                         choose)
            pts_local = self.pts_extractor(pts)
        pts_local_w_gt = self.pts_gt_extractor(pts_w_gt)
        r, t, s = self.pose_estimator_aux(pts, pts_w_gt, rgb_local, pts_local,
                                          pts_local_w_gt)
        return {"pts_local_w_gt": pts_local_w_gt, "pred_rotation": r,
                "pred_translation": t + c.squeeze(1), "pred_size": s}


def supervised_loss(end_points: dict, labels: dict):
    """PoseNetGT's loss, the pose distance alone: ``(total, parts)``."""
    total = losses.pose_dis(
        end_points["pred_rotation"], end_points["pred_translation"],
        end_points["pred_size"], labels["rotation_label"],
        labels["translation_label"], labels["size_label"])
    return total, {"total": total, "pose": total}
