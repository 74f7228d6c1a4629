"""Kernel 2: multi-radius ball query + grouping (``csrc/ball_query_group.cu``),
and its gradient.

Replaces the TPU kernel ``istnet_tpu/ops/ball_query_pallas.py:
_bq_group_kernel_t``. The plain version is ``ops/pointnet2.py::
ball_query_group``; the two give equal grouped values (the same radius
decisions, then a copy and one subtraction).

``BallQueryGroup`` is the op with its gradient, the counterpart of the
``jax.custom_vjp`` ``ball_query_pallas.ball_query_group``: the forward is
kernel 2; the backward (``_bqg_bwd``) recomputes the neighbour lists with
kernel 8 (``ops/ball_query.py``) and scatters the cotangents with
``ops/group_scatter.py``. It takes CUDA tensors only, as ``ops/dispatch.py``
routes them; on the CPU the plain grouping carries plain autograd.
"""

from __future__ import annotations

import ctypes

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops import ball_query as _bq
from istnet_tpu_torch.ops import group_scatter as _gs
from istnet_tpu_torch.ops.ball_query import MAX_NSAMPLE, MAX_RADII
from istnet_tpu_torch.ops.pointnet2 import ball_query_group as plain
from istnet_tpu_torch.ops.pointnet2 import radius_sq

SOURCE = "istnet_tpu_torch/csrc/ball_query_group.cu"
REPLACES = "istnet_tpu/ops/ball_query_pallas.py:445"

__all__ = ["BallQueryGroup", "ball_query_group_cuda", "plain"]


def ball_query_group_cuda(radii, nsamples, xyz: torch.Tensor,
                          new_xyz: torch.Tensor,
                          features: torch.Tensor | None = None,
                          out_dtype: torch.dtype = torch.float32) -> list:
    """Per radius ``(B, M, ns, 3 + C)`` = ``[xyz[idx] - centroid,
    features[idx]]`` in ``out_dtype``; up to 2 radii, ``ns <= 64``, all in
    one launch."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    if not 1 <= len(radii) <= MAX_RADII or len(radii) != len(nsamples):
        raise ValueError(f"ball_query_group: radii {radii}, nsamples "
                         f"{nsamples} (1 or 2 radii, one nsample each)")
    if any(not 1 <= ns <= MAX_NSAMPLE for ns in nsamples):
        raise ValueError(f"ball_query_group: nsamples {nsamples} > "
                         f"{MAX_NSAMPLE}")
    if out_dtype not in _build.F32_BF16:
        raise TypeError(f"ball_query_group: out_dtype {out_dtype}")
    tensors = (xyz, new_xyz) if features is None else (xyz, new_xyz, features)
    tensors = _build.cuda_inputs(
        "ball_query_group", *tensors,
        dtypes=[_build.F32, _build.F32, _build.F32_BF16][:len(tensors)])
    xyz, new_xyz = tensors[:2]
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if xyz.shape[-1] != 3 or new_xyz.shape != (b, m, 3) or n < 1:
        raise ValueError(f"ball_query_group: xyz {tuple(xyz.shape)}, "
                         f"new_xyz {tuple(new_xyz.shape)}")
    cf = 0
    feats_ptr = None
    feats_bf16 = False
    if features is not None:
        features = tensors[2]
        if features.shape[:2] != (b, n):
            raise ValueError(f"ball_query_group: features "
                             f"{tuple(features.shape)} vs xyz "
                             f"{tuple(xyz.shape)}")
        cf = features.shape[-1]
        feats_ptr = features.data_ptr()
        feats_bf16 = features.dtype == torch.bfloat16
    outs = [torch.empty(b, m, ns, 3 + cf, dtype=out_dtype, device=xyz.device)
            for ns in nsamples]
    nr = len(radii)
    r2 = (ctypes.c_float * nr)(*(radius_sq(r) for r in radii))
    ns_arr = (ctypes.c_int * nr)(*nsamples)
    out_arr = (ctypes.c_void_p * nr)(*(o.data_ptr() for o in outs))
    P, I = _build.P, _build.I
    fn = _build.function("istnet_ball_query_group",
                         [P, P, P, I, I, I, I, I, I, P, P, P, I, P])
    err = fn(xyz.data_ptr(), new_xyz.data_ptr(), feats_ptr, int(feats_bf16),
             b, n, m, cf, nr, ctypes.cast(r2, P), ctypes.cast(ns_arr, P),
             ctypes.cast(out_arr, P), int(out_dtype == torch.bfloat16),
             _build.stream(xyz))
    _build.check(err, "istnet_ball_query_group")
    ball_query_group_cuda.launches += 1
    return outs


ball_query_group_cuda.launches = 0


class BallQueryGroup(torch.autograd.Function):
    """``apply(radii, nsamples, out_dtype, xyz, new_xyz, features)`` -> a
    tuple of per-radius grouped tensors, differentiable in ``xyz``,
    ``new_xyz`` and ``features``. The backward takes float32 or bf16
    cotangents and sums them in float32 (``_bqg_bwd``'s bf16 branch): the
    points' and centroids' gradients in their dtypes, the features' in
    theirs; the decisions carry no gradient."""

    @staticmethod
    def forward(ctx, radii, nsamples, out_dtype, xyz, new_xyz, features):
        outs = ball_query_group_cuda(radii, nsamples, xyz, new_xyz, features,
                                     out_dtype)
        ctx.radii, ctx.nsamples = tuple(radii), tuple(nsamples)
        ctx.feat_dtype = None if features is None else features.dtype
        ctx.save_for_backward(xyz, new_xyz)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        xyz, new_xyz = ctx.saved_tensors
        idx_list = _bq.ball_query_multi_cuda(ctx.radii, ctx.nsamples,
                                             xyz.detach(), new_xyz.detach())
        points_bar, centroid_bar = _gs.group_scatter_cuda(idx_list, grads,
                                                          xyz.shape[1])
        xyz_bar = points_bar[..., :3].to(xyz.dtype)
        feat_bar = (None if ctx.feat_dtype is None
                    else points_bar[..., 3:].to(ctx.feat_dtype))
        return (None, None, None, xyz_bar, centroid_bar.to(new_xyz.dtype),
                feat_bar)
