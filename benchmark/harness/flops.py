"""Model FLOPs of the reference network, layer by layer from the
configuration's shapes: 2 a multiply-add of every convolution and
matrix product of the published IST-Net (``BASELINE.md``, "Per-instance
forward FLOPs": ~36.4 GFLOP at 192 x 192 and 1024 points), with the
trunk the configuration names (``backbone``: ResNet-101's forward is
~83.5 GFLOP there), whatever implements the work. ``up_3`` and the final
head count at every pixel of the dense map, even where a program
evaluates them at the chosen pixels only. BatchNorm, activations,
pooling, resizes and the point-set searches are not counted.

Training counts 3 x the forward of every trained module (forward and
the two products of the backward) and 1 x the frozen world enhancer's
forward.
"""

from __future__ import annotations

from benchmark.reference.model import TRUNKS

SA_MLPS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128, 256))
SA_NSAMPLES = (16, 32)
FP_MLPS = ((128, 128), (256, 256), (256, 256), (512, 512))


def _mlp(cin: int, chans, rows: int) -> float:
    total = 0.0
    for c in chans:
        total += 2.0 * cin * c * rows
        cin = c
    return total


def _conv(cin: int, cout: int, k: int, hw: int) -> float:
    return 2.0 * cin * cout * k * k * hw * hw


def trunk(img: int, backbone: str = "resnet18") -> tuple[float, int]:
    """The stride-8 trunk's FLOPs at ``img`` x ``img`` and its width: every
    block's convolutions and the 1x1 convolution of each downsample
    branch, by the reference's table of trunks."""
    block, depths = TRUNKS[backbone]
    bottleneck = block.expansion == 4
    s2, s4, s8 = img // 2, img // 4, img // 8
    f = _conv(3, 64, 7, s2)
    cin, hw = 64, s4
    for (planes, stride), depth in zip(((64, 1), (128, 2), (256, 1), (512, 1)),
                                       depths):
        out = planes * block.expansion
        for i in range(depth):
            hw_out = s8 if stride == 2 else hw
            if bottleneck:
                f += (_conv(cin, planes, 1, hw)
                      + _conv(planes, planes, 3, hw_out)
                      + _conv(planes, out, 1, hw_out))
            else:
                f += _conv(cin, planes, 3, hw_out) + _conv(planes, planes, 3,
                                                            hw_out)
            if i == 0 and (stride != 1 or cin != out):
                f += _conv(cin, out, 1, hw_out)
            cin, hw, stride = out, hw_out, 1
    return f, cin


def encoder(img: int, backbone: str = "resnet18") -> float:
    """The trunk (stride 8) + PSP at its width + up_1..3 + final at
    ``img`` x ``img``."""
    s8 = img // 8
    f, width = trunk(img, backbone)
    f += sum(2.0 * width * width * s * s for s in (1, 2, 3, 6))  # PSP stages
    f += _conv(width * 5, 1024, 1, s8)                            # bottleneck
    f += _conv(1024, 256, 3, 2 * s8) + _conv(256, 64, 3, 4 * s8) \
        + _conv(64, 64, 3, img) + _conv(64, 128, 1, img)    # up_1..3, final
    return f


def pointnet(n: int, npoints) -> float:
    """PointNet2MSG: 4 SA stages (two radii) and 4 FP stages."""
    f, cin, sa_out = 0.0, 0, []
    for i, m in enumerate(npoints):
        for ns in SA_NSAMPLES:
            f += _mlp(cin + 3, SA_MLPS[i], m * ns)
        cin = 2 * SA_MLPS[i][-1]
        sa_out.append(cin)
    sizes = [n, *npoints[:3]]
    skip = [0] + sa_out[:3]
    below = [FP_MLPS[1][-1], FP_MLPS[2][-1], FP_MLPS[3][-1], sa_out[3]]
    for i in range(4):
        f += _mlp(below[i] + skip[i], FP_MLPS[i], sizes[i])
    return f


def _heads() -> float:
    return 3 * 2.0 * (512 * 512 + 512 * 256) + 2.0 * 256 * (6 + 3 + 3)


def heavy(n: int) -> float:
    return (2 * _mlp(3, (32, 64), n) + _mlp(512, (256, 256), n)
            + _mlp(512, (512, 512), n) + _heads())


def light(n: int) -> float:
    return (_mlp(3, (32, 64), n) + _mlp(320, (256, 256), n)
            + _mlp(512, (512, 512), n) + _heads())


def deformer(n: int, nclass: int) -> float:
    return (_mlp(3, (32, 64), n) + _mlp(320, (384, 256), n)
            + _mlp(512, (384, 256, 128), n) + _mlp(128, (256, 128, nclass * 3), n))


def forward(cfg: dict) -> float:
    """Eval forward FLOPs of one instance."""
    n, img = cfg["sample_num"], cfg["img_size"]
    return (encoder(img, cfg["backbone"]) + pointnet(n, cfg["sa_npoints"])
            + deformer(n, cfg["num_category"]) + heavy(n))


def train_sample(cfg: dict) -> float:
    """Train-step FLOPs of one sample."""
    n = cfg["sample_num"]
    trained = forward(cfg) + light(n)
    world = pointnet(n, cfg["sa_npoints"])
    if cfg["freeze_world_enhancer"]:
        return 3.0 * trained + world
    return 3.0 * (trained + world + heavy(n))
