"""Kernel 8: multi-radius ball query, neighbour indices (``csrc/ball_query.cu``).

Replaces the TPU kernel ``istnet_tpu/ops/ball_query_pallas.py:
_ball_query_kernel``, which the grouping backward runs to recompute its
neighbour lists. The plain version is ``ops/pointnet2.py::ball_query_multi``;
the two give equal indices (the same radius decisions as the grouping
kernel, ``csrc/ball_query.cuh``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.pointnet2 import ball_query_multi as plain
from istnet_tpu_torch.ops.pointnet2 import radius_sq

SOURCE = "istnet_tpu_torch/csrc/ball_query.cu"
REPLACES = "istnet_tpu/ops/ball_query_pallas.py:30"
MAX_RADII = 2        # csrc/ball_query.cuh: kMaxRadii
MAX_NSAMPLE = 64     # csrc/ball_query.cuh: kMaxNs

__all__ = ["ball_query_multi_cuda", "plain"]


@functools.lru_cache(maxsize=None)
def _constants(radii: tuple, nsamples: tuple):
    """The C entry's r^2 (f32) and ns (int) arrays of these radii, built
    once a configuration (the C entry copies them)."""
    nr = len(radii)
    return ((ctypes.c_float * nr)(*(radius_sq(r) for r in radii)),
            (ctypes.c_int * nr)(*nsamples))


def ball_query_multi_cuda(radii, nsamples, xyz: torch.Tensor,
                          new_xyz: torch.Tensor) -> list:
    """Per radius ``(B, M, ns)`` int32 indices; up to 2 radii, ``ns <= 64``,
    all in one launch."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    if (not 1 <= len(radii) <= MAX_RADII or len(radii) != len(nsamples)
            or any(not 1 <= ns <= MAX_NSAMPLE for ns in nsamples)):
        raise ValueError(f"ball_query: radii {radii}, nsamples {nsamples} "
                         f"(1 or 2 radii, 1 <= ns <= {MAX_NSAMPLE})")
    xyz, new_xyz = _build.cuda_inputs("ball_query", xyz, new_xyz)
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    if xyz.shape[-1] != 3 or new_xyz.shape != (b, m, 3) or n < 1:
        raise ValueError(f"ball_query: xyz {tuple(xyz.shape)}, new_xyz "
                         f"{tuple(new_xyz.shape)}")
    # one allocation, a 16-byte aligned view a radius
    sizes = [-(-b * m * ns // 4) * 4 for ns in nsamples]
    flat = torch.empty(sum(sizes), dtype=torch.int32, device=xyz.device)
    outs = [part[:b * m * ns].view(b, m, ns)
            for part, ns in zip(flat.split(sizes), nsamples)]
    r2, ns_arr = _constants(radii, nsamples)
    out_arr = (ctypes.c_void_p * len(outs))(*(o.data_ptr() for o in outs))
    P, I = _build.P, _build.I
    fn = _build.function("istnet_ball_query", [P, P, I, I, I, I, P, P, P, P])
    err = fn(xyz.data_ptr(), new_xyz.data_ptr(), b, n, m, len(radii), r2,
             ns_arr, out_arr, _build.stream(xyz))
    _build.check(err, "istnet_ball_query")
    ball_query_multi_cuda.launches += 1
    return outs


ball_query_multi_cuda.launches = 0
