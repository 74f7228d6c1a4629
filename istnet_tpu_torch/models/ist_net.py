"""IST-Net, the model and its supervised loss (counterpart of
``istnet_tpu/models/ist_net.py``).

Inputs are a dict of tensors, channel-last as in the JAX package:

  rgb            (B, H, W, 3)   normalised crop (192 x 192 in production)
  pts            (B, N, 3)      camera-space points (metres)
  choose         (B, N)         flat pixel indices into the crop
  category_label (B,)           class id 0..nclass-1
  qo             (B, N, 3)      ground-truth NOCS points (training only)

Eval outputs: ``pred_rotation`` (B, 3, 3), ``pred_translation`` (B, 3),
``pred_size`` (B, 3), ``pred_qo`` (B, N, 3), all float32 under the float32
and bf16 compute policies (``nn/precision.py``), as is the centroid ``c``.

Train mode (``model.train()``) runs the train branch (JAX ``ist_net.py:
166-189``): the dense encoder map gathered at ``choose`` (the sparse head
is exact only at eval), the auxiliary camera-space head ``cam_enhancer``,
and ``world_enhancer``, a second PointNet2MSG over ``qo`` with the
world-space radii and, unless the world enhancer is frozen, a pose head on
the detached camera features. Its outputs add ``pts_w_local``,
``pts_w_local_gt`` and the auxiliary poses; ``supervised_loss`` turns them
into the training loss. Dropout draws its masks from the
``torch.Generator`` passed to ``forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from istnet_tpu_torch.models import losses
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
    """Train-only world-space extractor + pose head (JAX ``ist_net.py:
    114-131``). Frozen, it returns only the extractor's features, computed
    without a graph: nothing trains it, and the loss detaches them."""

    def __init__(self, sa_npoints):
        super().__init__()
        self.extractor = PointNet2MSG(WORLD_RADII, sa_npoints)
        self.pose_estimator = HeavyEstimator()

    def forward(self, pts, pts_w_gt, rgb_local, pts_local, freeze: bool):
        if freeze:
            with torch.no_grad():
                return None, self.extractor(pts_w_gt)
        pts_w_local_gt = self.extractor(pts_w_gt)
        pose = self.pose_estimator(pts, pts_w_gt, rgb_local.detach(),
                                   pts_local.detach(), pts_w_local_gt)
        return pose, pts_w_local_gt


class ISTNet(nn.Module):
    """The IST-Net model. ``sparse_eval_head`` evaluates the encoder's last
    stage at the chosen pixels only (exact at eval);
    ``freeze_world_enhancer`` selects the two-phase recipe's second phase
    (``config/ist_net_freeze_world_enhancer.yaml``)."""

    def __init__(self, nclass: int = 6,
                 sa_npoints=(512, 256, 128, 64),
                 sparse_eval_head: bool = True,
                 freeze_world_enhancer: bool = False):
        super().__init__()
        self.sparse_eval_head = sparse_eval_head
        self.freeze_world_enhancer = freeze_world_enhancer
        self.rgb_cam_extractor = ModifiedResnet()
        self.pts_cam_extractor = PointNet2MSG(CAM_RADII, sa_npoints)
        self.implicit_transform = ImplicitTransformation(nclass)
        self.main_estimator = HeavyEstimator()
        self.cam_enhancer = LightEstimator()
        self.world_enhancer = WorldSpaceEnhancer(sa_npoints)

    def forward(self, inputs: dict,
                generator: torch.Generator | None = None) -> dict:
        precision.apply_policy()
        rgb, pts, choose = inputs["rgb"], inputs["pts"], inputs["choose"]
        cls = inputs["category_label"].reshape(-1)

        c = pts.mean(dim=1, keepdim=True)
        pts = pts - c
        encoder = self.rgb_cam_extractor
        if self.sparse_eval_head and not self.training:
            rgb_local = encoder.sparse_points(rgb, choose)
        else:
            rgb_local = gather_by_choose(encoder(rgb, generator), choose)
        pts_local = self.pts_cam_extractor(pts)
        pts_w, pts_w_local = self.implicit_transform(rgb_local, pts_local,
                                                     pts, cls)
        r, t, s = self.main_estimator(pts, pts_w, rgb_local, pts_local,
                                      pts_w_local)
        c = c.squeeze(1)
        out = {"pred_qo": pts_w, "pred_rotation": r,
               "pred_translation": t + c, "pred_size": s}
        if not self.training:
            return out
        r_cam, t_cam, s_cam = self.cam_enhancer(pts, rgb_local, pts_local)
        pose_w, pts_w_local_gt = self.world_enhancer(
            pts, inputs["qo"], rgb_local, pts_local,
            self.freeze_world_enhancer)
        out.update(pts_w_local=pts_w_local, pts_w_local_gt=pts_w_local_gt,
                   pred_rotation_aux_cam=r_cam,
                   pred_translation_aux_cam=t_cam + c,
                   pred_size_aux_cam=s_cam)
        if pose_w is not None:
            r_w, t_w, s_w = pose_w
            out.update(pred_rotation_aux_world=r_w,
                       pred_translation_aux_world=t_w + c,
                       pred_size_aux_world=s_w)
        return out


def supervised_loss(end_points: dict, labels: dict, gamma1: float,
                    gamma2: float, freeze_world_enhancer: bool):
    """The IST-Net training loss (JAX ``ist_net.py:200-228``):
    ``PoseDis(main) + PoseDis(aux_cam) + gamma1 * SmoothL1(qo) + gamma2 *
    MSE(pts_w_local, pts_w_local_gt) [+ PoseDis(aux_world)]``, the target
    features detached in the frozen recipe. Returns ``(total, parts)``."""
    r_l, t_l, s_l = (labels["rotation_label"], labels["translation_label"],
                     labels["size_label"])
    target = end_points["pts_w_local_gt"]
    loss_feat = losses.feature_mse(
        end_points["pts_w_local"],
        target.detach() if freeze_world_enhancer else target)
    loss_qo = losses.smooth_l1_dis(end_points["pred_qo"], labels["qo"])
    loss_pose = losses.pose_dis(
        end_points["pred_rotation"], end_points["pred_translation"],
        end_points["pred_size"], r_l, t_l, s_l)
    loss_aux_cam = losses.pose_dis(
        end_points["pred_rotation_aux_cam"],
        end_points["pred_translation_aux_cam"],
        end_points["pred_size_aux_cam"], r_l, t_l, s_l)
    total = loss_pose + loss_aux_cam + gamma1 * loss_qo + gamma2 * loss_feat
    parts = {"pose": loss_pose, "aux_cam": loss_aux_cam, "qo": loss_qo,
             "feat": loss_feat}
    if not freeze_world_enhancer:
        loss_aux_world = losses.pose_dis(
            end_points["pred_rotation_aux_world"],
            end_points["pred_translation_aux_world"],
            end_points["pred_size_aux_world"], r_l, t_l, s_l)
        total = total + loss_aux_world
        parts["aux_world"] = loss_aux_world
    parts["total"] = total
    return total, parts
