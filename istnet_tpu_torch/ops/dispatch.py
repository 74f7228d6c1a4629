"""Device dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version, anything else raises.

Counterpart of ``istnet_tpu/ops/dispatch.py``. The choice is made on the
device of the tensor alone; a kernel that fails to build or launch raises,
it never falls back to the plain version.

Gradients: on the card the grouping and the FP interpolation run as
autograd Functions whose backward passes are kernels too (8 and the
grouping scatter, 10 and the interpolation scatter); on the CPU the plain
versions are differentiable as they stand. FPS gives indices, so it
detaches its input.
"""

from __future__ import annotations

import torch

from istnet_tpu_torch.ops import ball_query as _bq
from istnet_tpu_torch.ops import ball_query_group as _bqg
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


def fold_upsample_conv(x: torch.Tensor, k: torch.Tensor,
                       b: torch.Tensor | None,
                       epilogue: torch.Tensor | None = None) -> torch.Tensor:
    if _on_cuda(x):
        return _fold.fold_upsample_conv_cuda(x, k, b, epilogue)
    return _fold.plain(x, k, b, epilogue)


def sa_msg_fused(radii, nsamples, xyz: torch.Tensor, new_xyz: torch.Tensor,
                 features: torch.Tensor | None, folded) -> list:
    """The fused eval SA stage at every shape: the JAX package's shape
    gates (``n % 128``, ``m % tm``) came from Mosaic's tiling, not from the
    function."""
    if _on_cuda(xyz):
        return _sa.sa_msg_fused_cuda(radii, nsamples, xyz, new_xyz, features,
                                     folded)
    return _sa.plain(radii, nsamples, xyz, new_xyz, features, folded)
