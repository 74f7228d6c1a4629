"""Device dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version, anything else raises.

Counterpart of ``istnet_tpu/ops/dispatch.py``. The choice is made on the
device of the tensor alone; a kernel that fails to build or launch raises,
it never falls back to the plain version.

Gradients: on the card the grouping and the FP interpolation run as
autograd Functions whose backward passes are kernels too (8 and the
grouping scatter, 10 and the interpolation scatter); on the CPU the plain
versions are differentiable as they stand. FPS gives indices, so it
detaches its input. The eval BatchNorm pass is forward-only: a BatchNorm
whose output needs a gradient runs its own chain of PyTorch ops
(``nn/layers.py::BatchNorm.norm_act``).
"""

from __future__ import annotations

import torch

from istnet_tpu_torch.ops import ball_query as _bq
from istnet_tpu_torch.ops import ball_query_group as _bqg
from istnet_tpu_torch.ops import bn_eval as _bn
from istnet_tpu_torch.ops import depth_fill as _df
from istnet_tpu_torch.ops import fold_upsample as _fold
from istnet_tpu_torch.ops import fp_interpolate as _fpi
from istnet_tpu_torch.ops import fps as _fps
from istnet_tpu_torch.ops import group_scatter as _gs
from istnet_tpu_torch.ops import interp_scatter as _is
from istnet_tpu_torch.ops import sa_fused as _sa
from istnet_tpu_torch.ops import three_nn as _tnn
from istnet_tpu_torch.ops._build import on_cuda as _on_cuda

# name -> kernel module (SOURCE, REPLACES, plain, the launching wrapper)
KERNELS = {
    "fps": _fps,
    "ball_query_group": _bqg,
    "fp_interpolate": _fpi,
    "fold_upsample": _fold,
    "sa_fused": _sa,
    "ball_query": _bq,
    "group_scatter": _gs,
    "three_nn": _tnn,
    "interp_scatter": _is,
    "depth_fill": _df,
    "bn_eval": _bn,
}
_WRAPPERS = {
    "fps": _fps.furthest_point_sample_cuda,
    "ball_query_group": _bqg.ball_query_group_cuda,
    "fp_interpolate": _fpi.fp_interpolate_cuda,
    "fold_upsample": _fold.fold_upsample_conv_cuda,
    "sa_fused": _sa.sa_msg_fused_cuda,
    "ball_query": _bq.ball_query_multi_cuda,
    "group_scatter": _gs.group_scatter_cuda,
    "three_nn": _tnn.three_nn_cuda,
    "interp_scatter": _is.interp_scatter_cuda,
    "depth_fill": _df.fill_in_multiscale_cuda,
    "bn_eval": _bn.bn_eval_cuda,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def wrapper(name: str):
    """The launching CUDA wrapper of kernel ``name``."""
    return _WRAPPERS[name]


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    xyz = xyz.detach()
    if _on_cuda(xyz):
        return _fps.furthest_point_sample_cuda(xyz, npoint)
    return _fps.plain(xyz, npoint)


def ball_query_group(radii, nsamples, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     features: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.float32) -> list:
    if _on_cuda(xyz):
        return list(_bqg.BallQueryGroup.apply(radii, nsamples, out_dtype, xyz,
                                              new_xyz, features))
    return _bqg.plain(radii, nsamples, xyz, new_xyz, features, out_dtype)


def fp_interpolate(unknown: torch.Tensor, known: torch.Tensor,
                   feats: torch.Tensor) -> torch.Tensor:
    if _on_cuda(feats):
        return _fpi.FPInterpolate.apply(unknown, known, feats)
    return _fpi.plain(unknown, known, feats)


def fold_upsample_conv(x: torch.Tensor, k, b: torch.Tensor | None = None,
                       epilogue: torch.Tensor | None = None) -> torch.Tensor:
    """``k``: the HWIO kernel, or a ``fold_upsample.PackedFold`` that
    carries the kernel, the bias and the epilogue rows."""
    if _on_cuda(x):
        return _fold.fold_upsample_conv_cuda(x, k, b, epilogue)
    return _fold.plain(x, k, b, epilogue)


def sa_msg_fused(radii, nsamples, xyz: torch.Tensor, new_xyz: torch.Tensor,
                 features: torch.Tensor | None, folded) -> list:
    """The fused eval SA stage at every shape: the JAX package's shape
    gates (``n % 128``, ``m % tm``) came from Mosaic's tiling, not from the
    function. ``folded``: per radius and layer ``(W, b)``, or a
    ``sa_fused.PackedFolded`` of them."""
    if _on_cuda(xyz):
        return _sa.sa_msg_fused_cuda(radii, nsamples, xyz, new_xyz, features,
                                     folded)
    return _sa.plain(radii, nsamples, xyz, new_xyz, features, folded)


def fill_in_multiscale(depth: torch.Tensor,
                       max_depth: float = 3.0) -> torch.Tensor:
    """ip_basic depth completion of (B, H, W) metres at every ``H, W >= 5``;
    forward-only (it prepares inputs)."""
    depth = depth.detach()
    if _on_cuda(depth):
        return _df.fill_in_multiscale_cuda(depth, max_depth)
    return _df.plain(depth, max_depth)


def bn_eval(x: torch.Tensor, rows: torch.Tensor, act: str | None = None,
            residual: torch.Tensor | None = None,
            slope: torch.Tensor | None = None) -> torch.Tensor:
    """The eval BatchNorm (``rows`` = [mean, invstd, weight, bias]) and its
    consumer (``act`` None, "relu" with an optional residual added first,
    or "prelu" with ``slope``), forward-only; an empty map launches
    nothing."""
    if _on_cuda(x) and x.numel():
        return _bn.bn_eval_cuda(x, rows, act, residual, slope)
    return _bn.plain(x, rows, act, residual, slope)
