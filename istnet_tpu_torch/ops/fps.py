"""Kernel 1: furthest point sampling (``csrc/fps.cu``).

Replaces the TPU kernel ``istnet_tpu/ops/fps_pallas.py:_fps_kernel``. The
plain version is ``ops/pointnet2.py::furthest_point_sample``; the two give
equal indices (same d2 arithmetic, ties to the lowest index). Any cloud
size: past ``SHARED_MINIMA_MAX`` points the kernel keeps its running
minima in a workspace this wrapper allocates.
"""

from __future__ import annotations

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.pointnet2 import furthest_point_sample as plain

SOURCE = "istnet_tpu_torch/csrc/fps.cu"
REPLACES = "istnet_tpu/ops/fps_pallas.py:31"
# csrc/fps.cu's kSharedMinimaMax: past it the minima need a workspace
SHARED_MINIMA_MAX = 51200

__all__ = ["furthest_point_sample_cuda", "plain"]


def furthest_point_sample_cuda(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """``(B, N, 3)`` f32 CUDA -> ``(B, npoint)`` int32, any N >= 1."""
    (xyz,) = _build.cuda_inputs("furthest_point_sample", xyz)
    b, n, three = xyz.shape
    if three != 3 or n < 1 or npoint < 1:
        raise ValueError(f"furthest_point_sample: xyz {tuple(xyz.shape)}, "
                         f"npoint {npoint} (need (B, N>=1, 3))")
    out = torch.empty(b, npoint, dtype=torch.int32, device=xyz.device)
    work = (torch.empty(b, n, dtype=torch.float32, device=xyz.device)
            if n > SHARED_MINIMA_MAX else None)
    fn = _build.function("istnet_fps", [_build.P, _build.I, _build.I,
                                        _build.I, _build.P, _build.P,
                                        _build.P])
    err = fn(xyz.data_ptr(), b, n, npoint, out.data_ptr(),
             None if work is None else work.data_ptr(), _build.stream(xyz))
    _build.check(err, "istnet_fps")
    furthest_point_sample_cuda.launches += 1
    return out


furthest_point_sample_cuda.launches = 0
