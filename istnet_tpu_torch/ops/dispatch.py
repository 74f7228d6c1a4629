"""Device dispatch: a CUDA tensor goes to the hand-written kernel, a CPU
tensor to the kernel's plain PyTorch version, anything else raises.

Counterpart of ``istnet_tpu/ops/dispatch.py``. The choice is made on the
device of the tensor alone; a kernel that fails to build or launch raises,
it never falls back to the plain version.
"""

from __future__ import annotations

import torch

from istnet_tpu_torch.ops import ball_query_group as _bqg
from istnet_tpu_torch.ops import fold_upsample as _fold
from istnet_tpu_torch.ops import fp_interpolate as _fpi
from istnet_tpu_torch.ops import fps as _fps
from istnet_tpu_torch.ops import sa_fused as _sa

# name -> kernel module (SOURCE, REPLACES, plain, the launching wrapper)
KERNELS = {
    "fps": _fps,
    "ball_query_group": _bqg,
    "fp_interpolate": _fpi,
    "fold_upsample": _fold,
    "sa_fused": _sa,
}
_WRAPPERS = {
    "fps": _fps.furthest_point_sample_cuda,
    "ball_query_group": _bqg.ball_query_group_cuda,
    "fp_interpolate": _fpi.fp_interpolate_cuda,
    "fold_upsample": _fold.fold_upsample_conv_cuda,
    "sa_fused": _sa.sa_msg_fused_cuda,
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


def wrapper(name: str):
    """The launching CUDA wrapper of kernel ``name``."""
    return _WRAPPERS[name]


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    if _on_cuda(xyz):
        return _fps.furthest_point_sample_cuda(xyz, npoint)
    return _fps.plain(xyz, npoint)


def ball_query_group(radii, nsamples, xyz: torch.Tensor,
                     new_xyz: torch.Tensor,
                     features: torch.Tensor | None = None,
                     out_dtype: torch.dtype = torch.float32) -> list:
    if _on_cuda(xyz):
        return _bqg.ball_query_group_cuda(radii, nsamples, xyz, new_xyz,
                                          features, out_dtype)
    return _bqg.plain(radii, nsamples, xyz, new_xyz, features, out_dtype)


def fp_interpolate(unknown: torch.Tensor, known: torch.Tensor,
                   feats: torch.Tensor) -> torch.Tensor:
    if _on_cuda(feats):
        return _fpi.fp_interpolate_cuda(unknown, known, feats)
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
