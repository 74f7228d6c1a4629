"""RGB encoder: stride-8 ResNet (resnet18, or one of the factory's
34/50/101/152) + PSP + upsampling decoder.

Counterpart of ``istnet_tpu/nn/resnet_psp.py``, with the same faithfulness
notes: the reference's ResNet passes dilation 2/4 to layers 3/4 but never
applies it, so the network actually computed is stride-8 and dilation-1
everywhere, layers 3/4 at stride 1 with 1x1 downsample branches. That is
the network built here; do not "fix" the dilation.

Maps are NHWC, in the compute dtype (``nn/precision.py``). Dense convs run
through cuDNN, 1x1 convs and the folded upsample of ``up_1`` through
cuBLAS; ``up_2``'s fold-upsample conv with its BN + PReLU epilogue is the
hand-written kernel of ``ops/fold_upsample.py`` on CUDA tensors, in either
dtype, at eval only: its epilogue bakes in the running statistics, so in
training ``up_2`` takes the plain fold and then its own BN (batch
statistics) and PReLU, as JAX does (``fold_kernel=not train``,
``istnet_tpu/nn/resnet_psp.py:222-229``). Every other BN and the ReLU,
residual add or PReLU that takes its output are one eval pass of
``ops.bn_eval`` (``BatchNorm.norm_act``). Training also runs the three
``Dropout2d`` applications (``drop_1`` once, ``drop_2`` twice, each with a
mask of its own from the caller's generator). Submodule names follow the
reference torch keys (``model.feats.*``, ``model.psp.stages.{i}.1``,
``model.up_{1,2,3}.conv.{1,2,3}``, ``model.final.{0,1,2}``). Under a
profiler the stages are the spans ``feats``, ``psp`` (with ``drop_1``),
``up_1``, ``up_2`` (each with ``drop_2``) and ``up_3`` (with the final
head, dense or sparse; ``utils/tracing.py``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from istnet_tpu_torch import ops
from istnet_tpu_torch.nn.layers import (
    BatchNorm,
    DerivedCache,
    Dropout2d,
    PReLU,
    adaptive_avg_pool,
    cast,
    conv2d_nhwc,
    conv3x3_on_doubled,
    pointwise,
    resize_bilinear,
    resize_bilinear_align_corners,
)
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.nn.precision import compute_dtype
from istnet_tpu_torch.ops.fold_upsample import pack_fold
from istnet_tpu_torch.utils.tracing import span

class BasicBlock(nn.Module):
    """3x3 -> 3x3 (``istnet_tpu/nn/resnet_psp.py:73-94``)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = _downsample(inplanes, planes, stride, self.expansion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1.norm_act(conv2d_nhwc(x, self.conv1), "relu")
        out = conv2d_nhwc(out, self.conv2)
        return self.bn2.norm_act(out, "relu", _residual(self, x))


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with the stride -> 1x1 to 4x the planes
    (``istnet_tpu/nn/resnet_psp.py:97-124``); the 3x3 at dilation 1, as
    the network the reference builds runs it."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = _downsample(inplanes, planes, stride, self.expansion)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1.norm_act(conv2d_nhwc(x, self.conv1), "relu")
        out = self.bn2.norm_act(conv2d_nhwc(out, self.conv2), "relu")
        out = conv2d_nhwc(out, self.conv3)
        return self.bn3.norm_act(out, "relu", _residual(self, x))


def _downsample(inplanes: int, planes: int, stride: int, expansion: int):
    """The 1x1 + BN residual branch where the reference's condition asks
    for one: ``stride != 1 or inplanes != planes * expansion``
    (``istnet_tpu/nn/resnet_psp.py:157-160``)."""
    if stride == 1 and inplanes == planes * expansion:
        return None
    return nn.Sequential(
        nn.Conv2d(inplanes, planes * expansion, 1, stride, bias=False),
        BatchNorm(planes * expansion))


def _residual(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    if block.downsample is None:
        return x
    return block.downsample[1].norm_act(conv2d_nhwc(x, block.downsample[0]))


# block and stage depths of the reference's psp_models factory
# (istnet_tpu/nn/resnet_psp.py:130-134); the models build resnet18
RESNET_LAYERS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
}
# (planes, stride) of the four stages
STAGES = ((64, 1), (128, 2), (256, 1), (512, 1))


def check_backend(backend: str) -> None:
    if backend not in RESNET_LAYERS:
        raise NotImplementedError(
            f"backend {backend!r}: the reference's psp_models factory "
            f"defines {sorted(RESNET_LAYERS)} (modules.py:225-231)")


class ResNetTrunk(nn.Module):
    """Stride-8 trunk of ``backend`` returning the layer-4 map:
    ``out_channels`` 512 for the BasicBlock nets, 2048 for the Bottleneck
    nets."""

    def __init__(self, backend: str = "resnet18"):
        super().__init__()
        check_backend(backend)
        block, depths = RESNET_LAYERS[backend]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for li, ((planes, stride), depth) in enumerate(zip(STAGES, depths)):
            blocks = [block(inplanes, planes, stride)]
            inplanes = planes * block.expansion
            blocks += [block(inplanes, planes) for _ in range(depth - 1)]
            self.add_module(f"layer{li + 1}", nn.Sequential(*blocks))
        self.out_channels = inplanes
        # the reference trunk's classifier: loaded, never run
        self.fc = nn.Linear(inplanes, 1000)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.bn1.norm_act(conv2d_nhwc(x, self.conv1), "relu")
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for layer in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = layer(x)
        return x


class PSPModule(nn.Module):
    """Pyramid pooling: pool to 1/2/3/6, 1x1 conv each, upsample back
    (align_corners=False), concat with the input, 1x1 bottleneck + ReLU."""

    def __init__(self, features: int = 512, out_features: int = 1024,
                 sizes=(1, 2, 3, 6)):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(nn.AdaptiveAvgPool2d(size),
                          nn.Conv2d(features, features, 1, bias=False))
            for size in sizes)
        self.bottleneck = nn.Conv2d(features * (len(sizes) + 1),
                                    out_features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1], x.shape[2]
        priors = [resize_bilinear(pointwise(adaptive_avg_pool(
            x, stage[0].output_size), stage[1]), h, w)
                  for stage in self.stages]
        priors.append(x)
        return F.relu(pointwise(torch.cat(priors, dim=-1), self.bottleneck))


class PSPUpsample(nn.Module):
    """x2 bilinear (align_corners=True) + 3x3 conv + BN + PReLU, evaluated
    as the fold (``conv3x3_on_doubled``). ``fold_kernel=True`` sends the
    fold with its eval BN + PReLU epilogue through ``ops.fold_upsample_conv``
    at eval: the CUDA kernel on the card, the same plain fold on the CPU.
    The kernel's constants (the cast HWIO kernel packed for the GEMM, the
    cast bias, the epilogue rows) are built once per set of weights and
    compute dtype (``packed``)."""

    def __init__(self, cin: int, cout: int, fold_kernel: bool = False):
        super().__init__()
        self.fold_kernel = fold_kernel
        self._packed = DerivedCache()
        self.conv = nn.Sequential(
            nn.Upsample(scale_factor=2, mode="bilinear", align_corners=True),
            nn.Conv2d(cin, cout, 3, padding=1),
            BatchNorm(cout),
            PReLU())

    def epilogue(self) -> torch.Tensor:
        """(5, cout) rows [mean, invstd, scale, bias, alpha]."""
        bn, prelu = self.conv[2], self.conv[3]
        return torch.stack([bn.running_mean, bn.invstd(), bn.weight, bn.bias,
                            prelu.weight.expand_as(bn.bias)])

    def train(self, mode: bool = True):
        self._packed.clear()
        return super().train(mode)

    def packed(self):
        """The fold kernel's constants in the compute dtype, cached when no
        graph is recorded."""
        conv, bn, prelu = self.conv[1], self.conv[2], self.conv[3]

        def build():
            return pack_fold(cast(conv.weight.permute(2, 3, 1, 0)),
                             cast(conv.bias), self.epilogue())

        if torch.is_grad_enabled():
            return build()
        sources = (conv.weight, conv.bias, *bn.eval_tensors(), prelu.weight)
        return self._packed.get(sources, compute_dtype(), build)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv[1]
        k = cast(conv.weight.permute(2, 3, 1, 0))             # HWIO
        x, b = cast(x), cast(conv.bias)
        if self.fold_kernel and not self.training:
            if compute_dtype() != torch.float64:
                return ops.fold_upsample_conv(x, self.packed())
            # the float64 policy (the CPU parity tests') packs nothing: the
            # unpacked fold through the same dispatch, the plain fold on
            # the CPU; on the card the kernel's wrapper refuses float64
            y = ops.fold_upsample_conv(x, k, b)
        else:
            y = conv3x3_on_doubled(x, k, b)
        return _bn_prelu(self.conv, 2, y)


def _bn_prelu(seq: nn.Sequential, i: int, y: torch.Tensor) -> torch.Tensor:
    """``seq[i + 1](seq[i](y))`` for a BatchNorm at ``i`` and the PReLU
    after it: one eval pass (``BatchNorm.norm_act``)."""
    return seq[i].norm_act(y, "prelu", slope=seq[i + 1].weight)


class _PSPNet(nn.Module):
    def __init__(self, backend: str):
        super().__init__()
        self.feats = ResNetTrunk(backend)
        self.psp = PSPModule(self.feats.out_channels, 1024)
        self.drop_1 = Dropout2d(0.3)
        self.up_1 = PSPUpsample(1024, 256)
        self.up_2 = PSPUpsample(256, 64, fold_kernel=True)
        self.up_3 = PSPUpsample(64, 64)
        self.drop_2 = Dropout2d(0.15)
        self.final = nn.Sequential(nn.Conv2d(64, 128, 1), BatchNorm(128),
                                   PReLU())


class ModifiedResnet(nn.Module):
    """RGB encoder, (B, H, W, 3) -> per-pixel 128-d features at H x W.

    ``forward`` computes the dense map (training, and the dense eval head);
    ``sparse_points`` evaluates the last upsample stage and the final head
    only at the chosen pixels, exactly equal in eval mode
    (``istnet_tpu/nn/resnet_psp.py:288-394``). ``generator`` draws the
    dropout masks in training. Both set the policy's backend flags
    (``precision.apply_policy``), as ``ISTNet.forward`` does, so that the
    encoder runs alone as it runs in the model. ``backend`` names the
    trunk, one of ``RESNET_LAYERS`` (the models keep resnet18, as JAX's
    do); PSP maps any trunk's width to 1024 channels, so the decoder is the
    same."""

    def __init__(self, backend: str = "resnet18"):
        super().__init__()
        self.model = _PSPNet(backend)

    def _features96(self, x: torch.Tensor,
                    generator: torch.Generator | None = None) -> torch.Tensor:
        m = self.model
        with span("feats"):
            f = m.feats(x)
        with span("psp"):
            p = m.drop_1(m.psp(f), generator)
        with span("up_1"):
            p = m.drop_2(m.up_1(p), generator)
        with span("up_2"):
            return m.drop_2(m.up_2(p), generator)

    def _final(self, v: torch.Tensor) -> torch.Tensor:
        f = self.model.final
        return _bn_prelu(f, 1, pointwise(v, f[0]))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        precision.apply_policy()
        h = self._features96(x, generator)
        with span("up_3"):
            h = resize_bilinear_align_corners(h, 2 * h.shape[1],
                                              2 * h.shape[2])
            up3 = self.model.up_3.conv
            h = _bn_prelu(up3, 2, conv2d_nhwc(h, up3[1]))
            return self._final(h)

    def sparse_points(self, x: torch.Tensor, choose: torch.Tensor
                      ) -> torch.Tensor:
        """(B, H, W, 3), (B, N) flat pixel indices -> (B, N, 128)."""
        precision.apply_policy()
        up3 = self.model.up_3.conv
        h = self._features96(x)
        with span("up_3"):
            return _sparse_head(h, choose, up3[1],
                                lambda v: _bn_prelu(up3, 2, v), self._final)


def _axis_taps(center: torch.Tensor, scale: float, in_size: int):
    """Window base and (3, 3) lerp rows for output taps center-1..center+1
    along one axis (``istnet_tpu/nn/resnet_psp.py:330-347``)."""
    base = torch.clamp(torch.floor((center - 1).float() * scale).int(),
                       0, in_size - 3)                              # (B, N)
    offs = torch.tensor([-1, 0, 1], dtype=torch.int32, device=center.device)
    tap = center[..., None] + offs                                  # (B, N, 3)
    valid = (tap >= 0) & (tap < 2 * in_size)                        # zero pad
    pos = tap.float() * scale
    lo = torch.floor(pos).int()
    hi = torch.clamp(lo + 1, max=in_size - 1)
    w_hi = pos - lo.float()
    win = torch.arange(3, dtype=torch.int32, device=center.device)
    mat = ((win == (lo - base[..., None])[..., None]) * (1.0 - w_hi)[..., None]
           + (win == (hi - base[..., None])[..., None]) * w_hi[..., None])
    return base, mat * valid[..., None]


def _sparse_head(h: torch.Tensor, choose: torch.Tensor, conv: nn.Conv2d,
                 post_conv, final) -> torch.Tensor:
    """resize(x2, align_corners) -> 3x3 conv (zero pad) evaluated at the
    chosen output pixels only. All taps of one point live in a 3x3 input
    patch at ``base = clamp(floor((r-1)*s), 0, H_in-3)``; per-point (3, 3)
    lerp rows fold the resize, and the conv becomes one (9*C) matmul per
    point. The lerp matrices are cast to the patches' dtype; in bf16 the
    lerp is a 9-term sum in bf16, rounding after every product and add, as
    the JAX graph writes it (``resnet_psp.py:380-390``); in float32 it is
    one contraction, equal up to float32 summation order."""
    b, hin, win, c = h.shape
    wout = 2 * win
    n = choose.shape[1]
    choose = choose.int()
    base_y, mat_y = _axis_taps(choose // wout, (hin - 1) / (2 * hin - 1), hin)
    base_x, mat_x = _axis_taps(choose % wout, (win - 1) / (wout - 1), win)

    three = torch.arange(3, dtype=torch.int32, device=h.device)
    rows = (base_y[..., None] + three).long()                       # (B, N, 3)
    cols = (base_x[..., None] + three).long()
    bidx = torch.arange(b, device=h.device)[:, None, None, None]
    patches = h[bidx, rows[:, :, :, None], cols[:, :, None, :]]     # (B,N,3,3,C)
    mat_y, mat_x = mat_y.to(h.dtype), mat_x.to(h.dtype)
    w = mat_y[:, :, :, None, :, None] * mat_x[:, :, None, :, None, :]
    if h.dtype == torch.float32:
        resized = torch.einsum("bnijyx,bnyxc->bnijc", w, patches)
    else:
        resized = sum(w[..., y, x, None] * patches[:, :, None, None, y, x, :]
                      for y in range(3) for x in range(3))
    wm = conv.weight.permute(0, 2, 3, 1).reshape(conv.out_channels, 9 * c)
    v = F.linear(resized.reshape(b, n, 9 * c), cast(wm), cast(conv.bias))
    return final(post_conv(v))
