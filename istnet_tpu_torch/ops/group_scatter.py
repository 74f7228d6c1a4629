"""The grouping backward's scatter (``csrc/group_scatter.cu``).

The body of the TPU grouping backward ``istnet_tpu/ops/ball_query_pallas.py:
_bqg_bwd`` (a one-hot einsum there), run right after kernel 8. The plain
version is ``ops/pointnet2.py::group_scatter``. The kernel adds with f32
atomics, so its sums agree with the plain version's to f32 summation order
and change in the last bits from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.ball_query import MAX_NSAMPLE, MAX_RADII
from istnet_tpu_torch.ops.pointnet2 import group_scatter as plain

SOURCE = "istnet_tpu_torch/csrc/group_scatter.cu"
REPLACES = "istnet_tpu/ops/ball_query_pallas.py:593"

__all__ = ["group_scatter_cuda", "plain"]


def group_scatter_cuda(idx_list, grads, n: int):
    """Per radius ``idx (B, M, ns)`` int32 and the float32 cotangent ``(B,
    M, ns, 3 + C)`` of its grouped tensor -> ``points_bar (B, N, 3 + C)``
    and ``centroid_bar (B, M, 3)``, float32; up to 2 radii, ``ns <= 64``."""
    idx_list, grads = list(idx_list), list(grads)
    nr = len(idx_list)
    if not 1 <= nr <= MAX_RADII or len(grads) != nr:
        raise ValueError(f"group_scatter: {nr} index lists, {len(grads)} "
                         f"cotangents (1 or 2 radii)")
    tensors = _build.cuda_inputs("group_scatter", *idx_list, *grads,
                                 dtypes=[_build.I32] * nr + [_build.F32] * nr)
    idx_list, grads = tensors[:nr], tensors[nr:]
    b, m, _ = idx_list[0].shape
    c = grads[0].shape[-1]
    for idx, g in zip(idx_list, grads):
        ns = idx.shape[-1]
        if (idx.shape != (b, m, ns) or g.shape != (b, m, ns, c) or c < 3
                or not 1 <= ns <= MAX_NSAMPLE):
            raise ValueError(f"group_scatter: idx {tuple(idx.shape)}, "
                             f"cotangent {tuple(g.shape)}")
    dev = grads[0].device
    points_bar = torch.zeros(b, n, c, dtype=torch.float32, device=dev)
    centroid_bar = torch.empty(b, m, 3, dtype=torch.float32, device=dev)
    idx_arr = (ctypes.c_void_p * nr)(*(t.data_ptr() for t in idx_list))
    g_arr = (ctypes.c_void_p * nr)(*(t.data_ptr() for t in grads))
    ns_arr = (ctypes.c_int * nr)(*(t.shape[-1] for t in idx_list))
    P, I = _build.P, _build.I
    fn = _build.function("istnet_group_scatter",
                         [I, P, P, P, I, I, I, I, P, P, P])
    err = fn(nr, ctypes.cast(idx_arr, P), ctypes.cast(g_arr, P),
             ctypes.cast(ns_arr, P), b, n, m, c, points_bar.data_ptr(),
             centroid_bar.data_ptr(), _build.stream(points_bar))
    _build.check(err, "istnet_group_scatter")
    group_scatter_cuda.launches += 1
    return points_bar, centroid_bar


group_scatter_cuda.launches = 0
