"""Model FLOPs of the reference network, layer by layer from the
configuration's shapes: 2 a multiply-add of every convolution and
matrix product of the published IST-Net (``BASELINE.md``, "Per-instance
forward FLOPs": ~36.4 GFLOP at 192 x 192 and 1024 points), whatever
implements the work. ``up_3`` and the final head count at every pixel of
the dense map, even where a program evaluates them at the chosen pixels
only. BatchNorm, activations, pooling, resizes and the point-set
searches are not counted.

Training counts 3 x the forward of every trained module (forward and
the two products of the backward) and 1 x the frozen world enhancer's
forward.
"""

from __future__ import annotations

SA_MLPS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128, 256))
SA_NSAMPLES = (16, 32)
FP_MLPS = ((128, 128), (256, 256), (256, 256), (512, 512))


def _mlp(cin: int, chans, rows: int) -> float:
    total = 0.0
    for c in chans:
        total += 2.0 * cin * c * rows
        cin = c
    return total


def encoder(img: int) -> float:
    """ResNet-18 (stride 8) + PSP + up_1..3 + final at ``img`` x ``img``."""
    def conv(cin, cout, k, hw):
        return 2.0 * cin * cout * k * k * hw * hw

    s2, s4, s8 = img // 2, img // 4, img // 8
    f = conv(3, 64, 7, s2)
    f += 4 * conv(64, 64, 3, s4)                                  # layer1
    f += conv(64, 128, 3, s8) + conv(128, 128, 3, s8) + conv(64, 128, 1, s8) \
        + 2 * conv(128, 128, 3, s8)                               # layer2
    f += conv(128, 256, 3, s8) + conv(256, 256, 3, s8) + conv(128, 256, 1, s8) \
        + 2 * conv(256, 256, 3, s8)                               # layer3
    f += conv(256, 512, 3, s8) + conv(512, 512, 3, s8) + conv(256, 512, 1, s8) \
        + 2 * conv(512, 512, 3, s8)                               # layer4
    f += sum(2.0 * 512 * 512 * s * s for s in (1, 2, 3, 6))        # PSP stages
    f += conv(512 * 5, 1024, 1, s8)                               # bottleneck
    f += conv(1024, 256, 3, 2 * s8) + conv(256, 64, 3, 4 * s8) \
        + conv(64, 64, 3, img) + conv(64, 128, 1, img)            # up_1..3, final
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
    return (encoder(img) + pointnet(n, cfg["sa_npoints"])
            + deformer(n, cfg["num_category"]) + heavy(n))


def train_sample(cfg: dict) -> float:
    """Train-step FLOPs of one sample."""
    n = cfg["sample_num"]
    trained = forward(cfg) + light(n)
    world = pointnet(n, cfg["sa_npoints"])
    if cfg["freeze_world_enhancer"]:
        return 3.0 * trained + world
    return 3.0 * (trained + world + heavy(n))
