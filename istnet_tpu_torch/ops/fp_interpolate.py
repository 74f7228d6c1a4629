"""Kernel 3: fused 3-NN + inverse-distance interpolation
(``csrc/fp_interpolate.cu``), one PointNet++ FP gather stage, and its
gradient.

Replaces the TPU kernel ``istnet_tpu/ops/three_nn_pallas.py:
_fp_interp_kernel``. The plain version is ``ops/pointnet2.py::
fp_interpolate``; the two pick the same neighbours and agree to float32
summation order. Features may be float32 or bf16; the output has their
dtype, with float32 weights and sums and one rounding to bf16.

``FPInterpolate`` is the op with its gradient, the counterpart of the
``jax.custom_vjp`` ``three_nn_pallas.fp_interpolate``: the forward is kernel
3; the backward (``_fpi_bwd``) reruns the 3-NN search with kernel 10
(``ops/three_nn.py``), forms the weights in plain torch and scatters
``weight * cotangent`` with ``ops/interp_scatter.py``. Only the features
get a gradient: the reference's ThreeNN is not differentiable. It takes
CUDA tensors only, as ``ops/dispatch.py`` routes them; on the CPU the plain
interpolation carries plain autograd.
"""

from __future__ import annotations

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops import interp_scatter as _scatter
from istnet_tpu_torch.ops import three_nn as _tnn
from istnet_tpu_torch.ops.pointnet2 import fp_interpolate as plain
from istnet_tpu_torch.ops.pointnet2 import three_interpolate_weights
from istnet_tpu_torch.ops.three_nn import MAX_KNOWN

SOURCE = "istnet_tpu_torch/csrc/fp_interpolate.cu"
REPLACES = "istnet_tpu/ops/three_nn_pallas.py:93"

__all__ = ["FPInterpolate", "fp_interpolate_cuda", "plain"]


def fp_interpolate_cuda(unknown: torch.Tensor, known: torch.Tensor,
                        feats: torch.Tensor) -> torch.Tensor:
    """``(B, N, 3), (B, M, 3), (B, M, C) -> (B, N, C)``; 3 <= M <= 8192."""
    unknown, known, feats = _build.cuda_inputs(
        "fp_interpolate", unknown, known, feats,
        dtypes=[_build.F32, _build.F32, _build.F32_BF16])
    b, n, _ = unknown.shape
    m = known.shape[1]
    c = feats.shape[-1]
    if (unknown.shape[-1] != 3 or known.shape != (b, m, 3)
            or feats.shape[:2] != (b, m) or not 3 <= m <= MAX_KNOWN):
        raise ValueError(f"fp_interpolate: unknown {tuple(unknown.shape)}, "
                         f"known {tuple(known.shape)}, feats "
                         f"{tuple(feats.shape)}")
    out = torch.empty(b, n, c, dtype=feats.dtype, device=feats.device)
    P, I = _build.P, _build.I
    fn = _build.function("istnet_fp_interpolate",
                         [P, P, P, I, I, I, I, P, I, P])
    err = fn(unknown.data_ptr(), known.data_ptr(), feats.data_ptr(), b, n, m,
             c, out.data_ptr(), int(feats.dtype == torch.bfloat16),
             _build.stream(feats))
    _build.check(err, "istnet_fp_interpolate")
    fp_interpolate_cuda.launches += 1
    return out


fp_interpolate_cuda.launches = 0


class FPInterpolate(torch.autograd.Function):
    """``apply(unknown, known, feats)`` -> ``(B, N, C)``, differentiable in
    ``feats`` (float32 cotangents, the float32 policy); ``unknown`` and
    ``known`` get no gradient."""

    @staticmethod
    def forward(ctx, unknown, known, feats):
        ctx.m, ctx.feat_dtype = known.shape[1], feats.dtype
        ctx.save_for_backward(unknown, known)
        return fp_interpolate_cuda(unknown, known, feats)

    @staticmethod
    def backward(ctx, grad):
        unknown, known = ctx.saved_tensors
        if grad.dtype != torch.float32:
            raise TypeError("fp_interpolate backward: float32 cotangents "
                            "only (the float32 train policy)")
        dist, idx = _tnn.three_nn_cuda(unknown.detach(), known.detach())
        weight = three_interpolate_weights(dist)
        feats_bar = _scatter.interp_scatter_cuda(grad, idx, weight, ctx.m)
        return None, None, feats_bar.to(ctx.feat_dtype)
