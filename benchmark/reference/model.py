"""IST-Net (Liu et al., ICCV 2023; github.com/CVMI-Lab/IST-Net) in plain
PyTorch: the forward of both branches, the supervised loss, and the
precision the reference computes in.

The network is the one the published code builds:

- RGB encoder: a ResNet trunk of stride 8, one of the published trunk
  factory's (``psp_models`` in ``model/modules.py``): ResNet-18 (the
  published configuration's), 34, 50, 101 or 152, BasicBlocks of 3x3 ->
  3x3 or Bottlenecks of 1x1 -> 3x3 with the stride -> 1x1 to 4x the
  planes. The published code passes dilation 2/4 to layers 3/4 and never
  applies it, so layers 3 and 4 run at stride 1 and dilation 1 with 1x1
  downsample branches, in every trunk. Then pyramid pooling of the
  trunk's width (512, or 2048 for the Bottleneck trunks) to 1/2/3/6 with
  bilinear (align_corners=False) upsampling and a 1x1 bottleneck to 1024
  channels, three x2 bilinear (align_corners=True) upsamplings each
  followed by a 3x3 conv, BatchNorm and PReLU, and a 1x1 conv + BatchNorm
  + PReLU head to 128 channels at 192 x 192; Dropout2d 0.3 after the
  pyramid and 0.15 after ``up_1`` and ``up_2``.
- Points: two PointNet++ MSG extractors (camera and world radii), SA
  npoints from the configuration, nsamples 16/32, FP back to every point.
- Implicit space transformation, the main pose head, and in training the
  camera-space auxiliary head and the world-space enhancer.

Departures from the published code, all exact: activations are
channel-last for the point branch, as the port under test keeps them; the
per-point pixel features are read from the dense map by index; the
SharedMLPs' dense bias lives in their BatchNorm's running mean (the
weights the benchmark makes have no such bias).

Parameter and buffer names are those of the published state dict, so one
state dict made by the benchmark loads into this model and into the
program. Nothing here imports the program or JAX.

``Precision`` is what the reference computes in: ``float32`` (TF32 off,
the reference), or one of the controls the benchmark runs in the
program's place: ``tf32`` (TF32 on for every convolution and matrix
product) and ``fp8``, the bf16 compute policy one step down: every
convolution and matrix product reads its input, weight and bias rounded
to float8 e4m3 with a per-tensor scale and rounds its output so, which
leaves every activation between layers in fp8, where the bf16 policy
leaves it in bf16; BatchNorm arithmetic, the point-set geometry and the
loss stay float32, as under that policy; the gradient passes the
rounding straight through. ``bf16`` rounds the same tensors to bfloat16
and, on the way back, the gradient through each of them too, as the
policy's bf16 convolutions and products compute their gradients: the
bf16 policy itself, a witness of what its rounding alone does to a
number.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from . import ops

CAM_RADII = ((0.01, 0.02), (0.02, 0.04), (0.04, 0.08), (0.08, 0.16))
WORLD_RADII = ((0.05, 0.10), (0.10, 0.20), (0.20, 0.30), (0.30, 0.40))
SA_MLPS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128, 256))
SA_NSAMPLES = (16, 32)
FP_MLPS = ((128, 128), (256, 256), (256, 256), (512, 512))
FP8_MAX = 448.0


class _RoundBF16(torch.autograd.Function):
    """Round to bfloat16 on the way forward and the gradient on the way
    back."""

    @staticmethod
    def forward(ctx, t):
        return t.to(torch.bfloat16).to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


class Precision:
    """The arithmetic of convolutions and matrix products."""

    KINDS = ("float32", "tf32", "fp8", "bf16")

    def __init__(self, kind: str = "float32"):
        if kind not in self.KINDS:
            raise ValueError(f"precision {kind!r}: one of {self.KINDS}")
        self.kind = kind

    def apply_flags(self) -> None:
        tf32 = self.kind == "tf32"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32

    def q(self, t: torch.Tensor | None) -> torch.Tensor | None:
        if t is None or self.kind not in ("fp8", "bf16"):
            return t
        if self.kind == "bf16":
            return _RoundBF16.apply(t)
        scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return t + (rounded - t.detach())


class BatchNorm(nn.Module):
    """BatchNorm over the last axis: eval with the running statistics,
    train with the batch mean and biased variance (the unbiased one kept
    in ``batch_var`` for the running-statistics update)."""

    def __init__(self, c: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.batch_mean = self.batch_var = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            axes = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(x, dim=axes, correction=0)
            count = x.numel() // x.shape[-1]
            self.batch_mean = mean.detach()
            self.batch_var = var.detach() * (count / max(count - 1, 1))
            y = (x - mean) * torch.rsqrt(var + self.eps)
        else:
            y = (x - self.running_mean) * torch.rsqrt(self.running_var
                                                      + self.eps)
        return y * self.weight + self.bias


class PReLU(nn.Module):
    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


class Net(nn.Module):
    """A module that computes at the model's precision (``self.p``, set by
    ``ISTNet.set_precision``)."""

    p = Precision()

    def conv_nhwc(self, x, m: nn.Conv2d):
        """``m`` on an NHWC map."""
        q = self.p.q
        y = F.conv2d(q(x.permute(0, 3, 1, 2)), q(m.weight), q(m.bias),
                     m.stride, m.padding)
        return q(y.permute(0, 2, 3, 1))

    def dense(self, x, m):
        """A 1x1 conv or a linear layer on the last axis."""
        q = self.p.q
        return q(F.linear(q(x), q(m.weight.flatten(1)), q(m.bias)))


def dropout(x, rate: float, training: bool, generator):
    """Channel dropout of an NHWC map, the mask ``(B, 1, 1, C)`` drawn as
    ``rand < keep`` from ``generator``."""
    if not training:
        return x
    keep = 1.0 - rate
    draw = torch.rand((x.shape[0], 1, 1, x.shape[-1]), generator=generator,
                      device=generator.device)
    return x * ((draw < keep).to(x.dtype) * (1.0 / keep))


class BasicBlock(Net):
    """3x3 with the stride -> 3x3."""

    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False),
                BatchNorm(planes))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv_nhwc(x, self.conv1)))
        out = self.bn2(self.conv_nhwc(out, self.conv2))
        res = x if self.downsample is None else self.downsample[1](
            self.conv_nhwc(x, self.downsample[0]))
        return F.relu(out + res)


class Bottleneck(Net):
    """1x1 -> 3x3 with the stride -> 1x1 to 4x the planes, at dilation 1."""

    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                BatchNorm(planes * 4))

    def forward(self, x):
        out = F.relu(self.bn1(self.conv_nhwc(x, self.conv1)))
        out = F.relu(self.bn2(self.conv_nhwc(out, self.conv2)))
        out = self.bn3(self.conv_nhwc(out, self.conv3))
        res = x if self.downsample is None else self.downsample[1](
            self.conv_nhwc(x, self.downsample[0]))
        return F.relu(out + res)


#: the published trunk factory's blocks and stage depths
TRUNKS = {"resnet18": (BasicBlock, (2, 2, 2, 2)),
          "resnet34": (BasicBlock, (3, 4, 6, 3)),
          "resnet50": (Bottleneck, (3, 4, 6, 3)),
          "resnet101": (Bottleneck, (3, 4, 23, 3)),
          "resnet152": (Bottleneck, (3, 8, 36, 3))}


class Trunk(Net):
    """The ResNet ``backbone`` (a key of ``TRUNKS``) of stride 8; its
    output has ``width`` channels."""

    def __init__(self, backbone: str = "resnet18"):
        super().__init__()
        if backbone not in TRUNKS:
            raise ValueError(f"backbone {backbone!r}: one of {sorted(TRUNKS)}")
        block, depths = TRUNKS[backbone]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, ((planes, stride), depth) in enumerate(zip(
                ((64, 1), (128, 2), (256, 1), (512, 1)), depths)):
            blocks = [block(cin, planes, stride)]
            cin = planes * block.expansion
            blocks += [block(cin, planes, 1) for _ in range(depth - 1)]
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))
        self.width = cin
        self.fc = nn.Linear(cin, 1000)     # in the state dict, never run

    def forward(self, x):
        x = F.relu(self.bn1(self.conv_nhwc(x, self.conv1)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return x


class PSP(Net):
    def __init__(self, features: int = 512):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(s),
                          nn.Conv2d(features, features, 1, bias=False))
            for s in (1, 2, 3, 6))
        self.bottleneck = nn.Conv2d(features * 5, 1024, 1)

    def forward(self, x):
        h, w = x.shape[1:3]
        priors = []
        for stage in self.stages:
            pooled = F.adaptive_avg_pool2d(x.permute(0, 3, 1, 2),
                                           stage[0].output_size)
            y = self.dense(pooled.permute(0, 2, 3, 1), stage[1])
            priors.append(F.interpolate(
                y.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                align_corners=False).permute(0, 2, 3, 1))
        priors.append(x)
        return F.relu(self.dense(torch.cat(priors, dim=-1), self.bottleneck))


class Upsample(Net):
    """x2 bilinear (align_corners=True), 3x3 conv, BatchNorm, PReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(cin, cout, 3, padding=1), BatchNorm(cout), PReLU())

    def forward(self, x):
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2,
                           mode="bilinear", align_corners=True)
        return self.conv[3](self.conv[2](self.conv_nhwc(up.permute(0, 2, 3, 1),
                                                   self.conv[1])))


class PSPNet(Net):
    def __init__(self, backbone: str = "resnet18"):
        super().__init__()
        self.feats = Trunk(backbone)
        self.psp = PSP(self.feats.width)
        self.up_1 = Upsample(1024, 256)
        self.up_2 = Upsample(256, 64)
        self.up_3 = Upsample(64, 64)
        self.final = nn.Sequential(nn.Conv2d(64, 128, 1), BatchNorm(128),
                                   PReLU())


class Encoder(Net):
    """(B, H, W, 3) -> (B, H, W, 128)."""

    def __init__(self, backbone: str = "resnet18"):
        super().__init__()
        self.model = PSPNet(backbone)

    def forward(self, x, generator=None):
        m, t = self.model, self.training
        p = dropout(m.psp(m.feats(x)), 0.3, t, generator)
        p = dropout(m.up_1(p), 0.15, t, generator)
        p = dropout(m.up_2(p), 0.15, t, generator)
        p = m.up_3(p)
        return m.final[2](m.final[1](self.dense(p, m.final[0])))


class _Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.bn = BatchNorm(c)


class _MLPLayer(Net):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.normlayer = _Norm(cout)

    def forward(self, x):
        return F.relu(self.normlayer.bn(self.dense(x, self.conv)))


class SharedMLP(nn.Sequential):
    def __init__(self, channels):
        super().__init__()
        for k in range(len(channels) - 1):
            self.add_module(f"layer{k}", _MLPLayer(channels[k],
                                                   channels[k + 1]))


class SAModule(nn.Module):
    def __init__(self, npoint: int, radii, mlps):
        super().__init__()
        self.npoint, self.radii = npoint, tuple(radii)
        self.mlps = nn.ModuleList(SharedMLP(s) for s in mlps)

    def forward(self, xyz, feats):
        new_xyz = ops.gather_points(
            xyz, ops.furthest_point_sample(xyz, self.npoint))
        out = [mlp(ops.ball_query_group(r, ns, xyz, new_xyz, feats)
                   ).amax(dim=2)
               for r, ns, mlp in zip(self.radii, SA_NSAMPLES, self.mlps)]
        return new_xyz, torch.cat(out, dim=-1)


class FPModule(nn.Module):
    def __init__(self, mlp):
        super().__init__()
        self.mlp = SharedMLP(mlp)

    def forward(self, unknown, known, unknown_feats, known_feats):
        x = ops.three_interpolate(unknown, known, known_feats)
        if unknown_feats is not None:
            x = torch.cat([x, unknown_feats], dim=-1)
        return self.mlp(x)


class PointNet2MSG(nn.Module):
    def __init__(self, radii, npoints):
        super().__init__()
        self.SA_modules = nn.ModuleList()
        sa_out, cin = [], 0
        for i in range(4):
            mlps = [[cin + 3, *SA_MLPS[i]] for _ in SA_NSAMPLES]
            self.SA_modules.append(SAModule(npoints[i], radii[i], mlps))
            cin = sum(m[-1] for m in mlps)
            sa_out.append(cin)
        skip = [0] + sa_out[:3]
        below = [FP_MLPS[1][-1], FP_MLPS[2][-1], FP_MLPS[3][-1], sa_out[3]]
        self.FP_modules = nn.ModuleList(
            FPModule([below[i] + skip[i], *FP_MLPS[i]]) for i in range(4))

    def forward(self, xyz):
        l_xyz, l_feats = [xyz], [None]
        for sa in self.SA_modules:
            nxyz, nfeat = sa(l_xyz[-1], l_feats[-1])
            l_xyz.append(nxyz)
            l_feats.append(nfeat)
        for i in range(-1, -5, -1):
            l_feats[i - 1] = self.FP_modules[i](l_xyz[i - 1], l_xyz[i],
                                                l_feats[i - 1], l_feats[i])
        return l_feats[0]


class MLP(nn.Sequential, Net):
    """1x1 conv (or linear) + ReLU chain on the last axis; the ReLU after
    the last layer only with ``final_act``."""

    def __init__(self, cin, channels, final_act=True, linear=False):
        layers = []
        for i, c in enumerate(channels):
            layers.append(nn.Linear(cin, c) if linear else nn.Conv1d(cin, c, 1))
            if final_act or i + 1 < len(channels):
                layers.append(nn.ReLU())
            cin = c
        nn.Sequential.__init__(self, *layers)

    def forward(self, x):
        for m in self:
            x = F.relu(x) if isinstance(m, nn.ReLU) else self.dense(x, m)
        return x


def _with_mean(x):
    return torch.cat([x, x.mean(dim=1, keepdim=True).expand_as(x)], dim=-1)


def ortho6d_to_mat(x_raw, y_raw):
    def unit(v):
        return v / torch.clamp(torch.sqrt(torch.sum(v * v, -1, keepdim=True)),
                               min=1e-8)
    y = unit(y_raw)
    z = unit(torch.linalg.cross(x_raw, y, dim=-1))
    x = torch.linalg.cross(y, z, dim=-1)
    return torch.stack([x, y, z], dim=-1)


class PoseHeads(nn.Module):
    def __init__(self):
        super().__init__()
        self.rotation_estimator = MLP(512, (512, 256, 6), False, True)
        self.translation_estimator = MLP(512, (512, 256, 3), False, True)
        self.size_estimator = MLP(512, (512, 256, 3), False, True)

    def heads(self, feat):
        """(R, t, s) and the 6D rotation R is made from."""
        r6 = self.rotation_estimator(feat)
        return (ortho6d_to_mat(r6[:, :3], r6[:, 3:]),
                self.translation_estimator(feat), self.size_estimator(feat),
                r6)


class HeavyEstimator(PoseHeads):
    def __init__(self):
        super().__init__()
        self.pts_mlp1 = MLP(3, (32, 64))
        self.pts_mlp2 = MLP(3, (32, 64))
        self.pose_mlp1 = MLP(512, (256, 256))
        self.pose_mlp2 = MLP(512, (512, 512))

    def forward(self, pts, pts_w, rgb_local, pts_local, pts_w_local):
        f = torch.cat([rgb_local, self.pts_mlp1(pts), pts_local,
                       self.pts_mlp2(pts_w), pts_w_local], dim=-1)
        return self.heads(self.pose_mlp2(_with_mean(self.pose_mlp1(f)))
                          .mean(dim=1))


class LightEstimator(PoseHeads):
    def __init__(self):
        super().__init__()
        self.pts_mlp = MLP(3, (32, 64))
        self.pose_mlp1 = MLP(320, (256, 256))
        self.pose_mlp2 = MLP(512, (512, 512))

    def forward(self, pts, rgb_local, pts_local):
        f = torch.cat([rgb_local, self.pts_mlp(pts), pts_local], dim=-1)
        return self.heads(self.pose_mlp2(_with_mean(self.pose_mlp1(f)))
                          .mean(dim=1))


class FeatureDeformer(nn.Module):
    def __init__(self, nclass: int):
        super().__init__()
        self.nclass = nclass
        self.pts_mlp1 = MLP(3, (32, 64))
        self.deform_mlp1 = MLP(320, (384, 256))
        self.deform_mlp2 = MLP(512, (384, 256, 128))
        self.pred_nocs = MLP(128, (256, 128, nclass * 3), final_act=False)

    def forward(self, pts, rgb_local, pts_local, cls):
        b, n, _ = pts.shape
        f = torch.cat([self.pts_mlp1(pts), pts_local, rgb_local], dim=-1)
        local_w = self.deform_mlp2(_with_mean(self.deform_mlp1(f)))
        nocs = self.pred_nocs(local_w).reshape(b, n, self.nclass, 3)
        return local_w, nocs[torch.arange(b, device=cls.device), :, cls]


class ImplicitTransformation(nn.Module):
    def __init__(self, nclass: int):
        super().__init__()
        self.feature_refine = FeatureDeformer(nclass)


class WorldEnhancer(nn.Module):
    def __init__(self, npoints):
        super().__init__()
        self.extractor = PointNet2MSG(WORLD_RADII, npoints)
        self.pose_estimator = HeavyEstimator()


class ISTNet(nn.Module):
    def __init__(self, nclass: int = 6, npoints=(512, 256, 128, 64),
                 freeze_world_enhancer: bool = False,
                 backbone: str = "resnet18"):
        super().__init__()
        self.freeze_world_enhancer = freeze_world_enhancer
        self.rgb_cam_extractor = Encoder(backbone)
        self.pts_cam_extractor = PointNet2MSG(CAM_RADII, npoints)
        self.implicit_transform = ImplicitTransformation(nclass)
        self.main_estimator = HeavyEstimator()
        self.cam_enhancer = LightEstimator()
        self.world_enhancer = WorldEnhancer(npoints)

    def set_precision(self, p: Precision) -> "ISTNet":
        for m in self.modules():
            if isinstance(m, Net):
                m.p = p
        self.p = p
        return self

    def forward(self, inputs: dict, generator=None) -> dict:
        p = getattr(self, "p", Precision())
        p.apply_flags()
        pts, choose = inputs["pts"].float(), inputs["choose"].long()
        cls = inputs["category_label"].reshape(-1).long()
        c = pts.mean(dim=1, keepdim=True)
        pts = pts - c
        fmap = self.rgb_cam_extractor(inputs["rgb"].float(), generator)
        b, h, w, ch = fmap.shape
        rgb_local = fmap.reshape(b, h * w, ch)[
            torch.arange(b, device=fmap.device)[:, None], choose]
        pts_local = self.pts_cam_extractor(pts)
        local_w, pts_w = self.implicit_transform.feature_refine(
            pts, rgb_local, pts_local, cls)
        r, t, s, r6 = self.main_estimator(pts, pts_w, rgb_local, pts_local,
                                          local_w)
        c = c.squeeze(1)
        out = {"pred_qo": pts_w, "pred_rotation": r,
               "pred_translation": t + c, "pred_size": s, "rot6d": r6}
        if not self.training:
            return out
        r_c, t_c, s_c, _ = self.cam_enhancer(pts, rgb_local, pts_local)
        out.update(pts_w_local=local_w, pred_rotation_aux_cam=r_c,
                   pred_translation_aux_cam=t_c + c, pred_size_aux_cam=s_c)
        we = self.world_enhancer
        if self.freeze_world_enhancer:
            with torch.no_grad():
                out["pts_w_local_gt"] = we.extractor(inputs["qo"].float())
        else:
            gt = we.extractor(inputs["qo"].float())
            r_w, t_w, s_w, _ = we.pose_estimator(
                pts, inputs["qo"].float(), rgb_local.detach(),
                pts_local.detach(), gt)
            out.update(pts_w_local_gt=gt, pred_rotation_aux_world=r_w,
                       pred_translation_aux_world=t_w + c,
                       pred_size_aux_world=s_w)
        return out


def _norm(d, dim):
    sq = torch.sum(d * d, dim=dim)
    pos = sq > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)


def pose_dis(r1, t1, s1, r2, t2, s2):
    return (_norm(r1 - r2, 1).mean() + _norm(t1 - t2, 1).mean()
            + _norm(s1 - s2, 1).mean())


def supervised_loss(out: dict, labels: dict, gamma1: float, gamma2: float,
                    frozen: bool):
    """``(total, parts)``: PoseDis of the main and auxiliary heads, gamma1 x
    smooth-L1 (threshold 0.1) of the NOCS points, gamma2 x MSE of the
    world-space features (the target detached when frozen)."""
    r, t, s = (labels["rotation_label"], labels["translation_label"],
               labels["size_label"])
    target = out["pts_w_local_gt"]
    feat = torch.mean(torch.square(
        out["pts_w_local"] - (target.detach() if frozen else target)))
    diff = torch.abs(out["pred_qo"] - labels["qo"])
    qo = torch.where(diff > 0.1, diff - 0.05,
                     torch.square(diff) / 0.2).sum(dim=-1).mean()
    parts = {"pose": pose_dis(out["pred_rotation"], out["pred_translation"],
                              out["pred_size"], r, t, s),
             "aux_cam": pose_dis(out["pred_rotation_aux_cam"],
                                 out["pred_translation_aux_cam"],
                                 out["pred_size_aux_cam"], r, t, s),
             "qo": qo, "feat": feat}
    total = parts["pose"] + parts["aux_cam"] + gamma1 * qo + gamma2 * feat
    if not frozen:
        parts["aux_world"] = pose_dis(out["pred_rotation_aux_world"],
                                      out["pred_translation_aux_world"],
                                      out["pred_size_aux_world"], r, t, s)
        total = total + parts["aux_world"]
    parts["total"] = total
    return total, parts
