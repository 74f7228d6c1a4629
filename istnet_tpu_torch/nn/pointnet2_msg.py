"""PointNet++ multi-scale-grouping feature extractor.

Counterpart of ``istnet_tpu/nn/pointnet2_msg.py``: 4 set-abstraction stages
(FPS -> gather -> two-radius ball query + group -> SharedMLP -> max over
the slots) and 4 feature-propagation stages (fused 3-NN interpolation ->
SharedMLP) back to N points. FPS, the grouping and the interpolation go
through ``istnet_tpu_torch.ops``: CUDA kernels on the card, their plain
versions on the CPU; the SharedMLPs are cuBLAS matmuls. Under the bf16
policy at eval, SA stages with features (2-4) run whole as the fused SA
kernel (``ops.sa_msg_fused``) with the BN folded into the weights; stage
1 stays unfused, as the JAX default keeps it (``istnet_tpu/ops/dispatch.py:
155``). In training every stage runs unfused, its SharedMLPs with BN batch
statistics, and the grouping and the interpolation carry gradients (their
backward kernels on the card); the slot max is ``amax``, which splits the
gradient evenly among tied slots as JAX's max does (pad slots repeat the
first hit, so ties are exact).

Submodule names follow the reference torch keys (``SA_modules.{i}.mlps.{j}
.layer{k}.conv`` / ``.normlayer.bn``, ``FP_modules.{i}.mlp.layer{k}``), so
a reference state dict loads as it is. Layout is channel-last. Under a
profiler each stage is a span, ``sa1``-``sa4`` and ``fp1``-``fp4``, its
FPS, grouping or 3-NN inside it (``utils/tracing.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from istnet_tpu_torch import ops
from istnet_tpu_torch.nn.layers import BatchNorm, DerivedCache, pointwise
from istnet_tpu_torch.nn.precision import compute_dtype
from istnet_tpu_torch.ops.sa_fused import pack_folded
from istnet_tpu_torch.utils.tracing import span

SA_MLPS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128, 256))
SA_NSAMPLES = (16, 32)
FP_MLPS = ((128, 128), (256, 256), (256, 256), (512, 512))
# the stages' spans (``utils/tracing.py``): FP_modules[i] is fp{i + 1}
SA_SPANS = ("sa1", "sa2", "sa3", "sa4")
FP_SPANS = ("fp1", "fp2", "fp3", "fp4")


class _NormLayer(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm(channels)


class _SharedMLPLayer(nn.Module):
    """Bias-free 1x1 conv + BN + ReLU (the JAX SharedMLP's dense bias is
    folded into the BN running mean by the weight bridge, exact at eval);
    BN and ReLU are one eval pass (``BatchNorm.norm_act``)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, 1, bias=False)
        self.normlayer = _NormLayer(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.normlayer.bn.norm_act(pointwise(x, self.conv), "relu")


class SharedMLP(nn.Sequential):
    """Per-point MLP over the last axis; ``channels[0]`` is the input width."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        for k in range(len(channels) - 1):
            self.add_module(f"layer{k}",
                            _SharedMLPLayer(channels[k], channels[k + 1]))


def _fold_shared_mlp(sm: SharedMLP) -> tuple:
    """Eval-BN folding of a SharedMLP (``istnet_tpu/nn/pointnet2_msg.py:
    50-69``), in float32: per layer ``(W', b')`` with ``W' = W * k`` and
    ``b' = (b - mean) * k + bias``, ``k = scale * rsqrt(var + eps)``, so that
    ``relu(x @ W' + b') == relu(BN(x @ W + b))``. The JAX dense bias ``b``
    sits in the running mean here (the weight bridge puts it there), so
    ``b - mean`` is ``-running_mean``, an exact negation."""
    layers = []
    for layer in sm:
        bn = layer.normlayer.bn
        k = bn.weight * bn.invstd()
        w = layer.conv.weight.flatten(1).t()                # (c_in, c_out)
        layers.append((w * k, -bn.running_mean * k + bn.bias))
    return tuple(layers)


class PointnetSAModuleMSG(nn.Module):
    """Set abstraction with multi-scale grouping (use_xyz=True).

    The fused path's BN-folded weights are folded and packed for the kernel
    once (``folded``) and kept until a parameter or buffer they come from
    changes."""

    def __init__(self, npoint: int, radii: Sequence[float],
                 nsamples: Sequence[int], mlps: Sequence[Sequence[int]]):
        super().__init__()
        self.npoint = npoint
        self.radii = tuple(radii)
        self.nsamples = tuple(nsamples)
        self.mlps = nn.ModuleList(SharedMLP(spec) for spec in mlps)
        self._folded = DerivedCache()

    def train(self, mode: bool = True):
        self._folded.clear()
        return super().train(mode)

    def folded(self):
        """The eval-BN-folded MLPs of the radii: packed for the kernel and
        cached when no graph is recorded, else plain float32 tuples."""
        def fold():
            return [_fold_shared_mlp(mlp) for mlp in self.mlps]

        if torch.is_grad_enabled():
            return fold()
        sources = [t for mlp in self.mlps for layer in mlp
                   for t in (layer.conv.weight, *layer.normlayer.bn.eval_tensors())]
        return self._folded.get(sources, None, lambda: pack_folded(fold()))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor | None):
        fps_idx = ops.furthest_point_sample(xyz, self.npoint)
        new_xyz = ops.gather_points(xyz, fps_idx)             # (B, np, 3)
        dt = compute_dtype()
        # the gate of pointnet2_msg.py:98-107: eval, the bf16 policy (the
        # kernel's MLP runs bf16, which an f32 policy must never take) and
        # features present (stage 1 stays unfused)
        if (not self.training and dt == torch.bfloat16
                and features is not None):
            fused = ops.sa_msg_fused(self.radii, self.nsamples, xyz, new_xyz,
                                     features, self.folded())
            return new_xyz, torch.cat([f.to(dt) for f in fused], dim=-1)
        grouped = ops.ball_query_group(self.radii, self.nsamples, xyz,
                                       new_xyz, features, out_dtype=dt)
        feats = [mlp(g).amax(dim=2) for g, mlp in zip(grouped, self.mlps)]
        return new_xyz, torch.cat(feats, dim=-1)


class PointnetFPModule(nn.Module):
    """Feature propagation: fused 3-NN interpolation + SharedMLP."""

    def __init__(self, mlp: Sequence[int]):
        super().__init__()
        self.mlp = SharedMLP(mlp)

    def forward(self, unknown: torch.Tensor, known: torch.Tensor,
                unknown_feats: torch.Tensor | None,
                known_feats: torch.Tensor) -> torch.Tensor:
        interp = ops.fp_interpolate(unknown, known, known_feats)
        if unknown_feats is not None:
            interp = torch.cat([interp, unknown_feats], dim=-1)
        return self.mlp(interp)


class PointNet2MSG(nn.Module):
    """The reference's 4-stage MSG network on bare points: (B, N, 3) ->
    (B, N, 128), as IST-Net uses it.

    ``radii_list`` selects the camera-space or world-space radii;
    ``npoints`` the SA stage sizes (512/256/128/64 in the reference, small
    for tests)."""

    def __init__(self, radii_list: Sequence[Sequence[float]],
                 npoints: Sequence[int] = (512, 256, 128, 64)):
        super().__init__()
        self.SA_modules = nn.ModuleList()
        sa_out = []
        c_in = 0
        for i in range(4):
            mlps = [[c_in + 3, *SA_MLPS[i]] for _ in SA_NSAMPLES]
            self.SA_modules.append(PointnetSAModuleMSG(
                npoints[i], radii_list[i], SA_NSAMPLES, mlps))
            c_in = sum(m[-1] for m in mlps)
            sa_out.append(c_in)
        # FP_modules[i] runs i-th from the bottom; its input is the
        # interpolated output of the stage below plus the skip features
        skip = [0] + sa_out[:3]
        below = [FP_MLPS[1][-1], FP_MLPS[2][-1], FP_MLPS[3][-1], sa_out[3]]
        self.FP_modules = nn.ModuleList(
            PointnetFPModule([below[i] + skip[i], *FP_MLPS[i]])
            for i in range(4))

    def forward(self, xyz: torch.Tensor) -> torch.Tensor:
        if xyz.shape[-1] != 3:
            raise ValueError(f"PointNet2MSG takes (B, N, 3) points, got "
                             f"{tuple(xyz.shape)}")
        l_xyz, l_feats = [xyz], [None]
        for i, sa in enumerate(self.SA_modules):
            with span(SA_SPANS[i]):
                nxyz, nfeat = sa(l_xyz[-1], l_feats[-1])
            l_xyz.append(nxyz)
            l_feats.append(nfeat)
        for i in range(-1, -(len(self.FP_modules) + 1), -1):
            with span(FP_SPANS[i]):
                l_feats[i - 1] = self.FP_modules[i](
                    l_xyz[i - 1], l_xyz[i], l_feats[i - 1], l_feats[i])
        return l_feats[0]
