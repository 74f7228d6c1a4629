"""The grouping backward's scatter (``csrc/group_scatter.cu``).

The body of the TPU grouping backward ``istnet_tpu/ops/ball_query_pallas.py:
_bqg_bwd`` (a one-hot einsum there), run right after kernel 8. The plain
version is ``ops/pointnet2.py::group_scatter``. The kernel inverts the
index maps on the card and lets each point gather its slots' cotangents in
a fixed order (``csrc/scatter_invert.cuh``): no atomic add into the
outputs, so two calls give the same bits, and its sums agree with the plain
version's to f32 summation order. One call makes two launches and counts
one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.ball_query import MAX_NSAMPLE, MAX_RADII
from istnet_tpu_torch.ops.pointnet2 import group_scatter as plain

SOURCE = "istnet_tpu_torch/csrc/group_scatter.cu"
REPLACES = "istnet_tpu/ops/ball_query_pallas.py:593"

__all__ = ["group_scatter_cuda", "plain"]


@functools.lru_cache(maxsize=64)
def _workspace_bytes(ns: tuple, b: int, n: int, m: int, c: int) -> int:
    nbytes = ctypes.c_longlong(0)
    fn = _build.function("istnet_group_scatter_workspace",
                         [_build.I, _build.P, _build.I, _build.I, _build.I,
                          _build.I, _build.P])
    ns_arr = (ctypes.c_int * len(ns))(*ns)
    _build.check(fn(len(ns), ctypes.cast(ns_arr, _build.P), b, n, m, c,
                    ctypes.byref(nbytes)), "istnet_group_scatter_workspace")
    return nbytes.value


def group_scatter_cuda(idx_list, grads, n: int):
    """Per radius ``idx (B, M, ns)`` int32 and the float32 or bf16
    cotangent ``(B, M, ns, 3 + C)`` of its grouped tensor (one dtype for
    all) -> ``points_bar (B, N, 3 + C)`` and ``centroid_bar (B, M, 3)``,
    float32; up to 2 radii, ``ns <= 64``."""
    idx_list, grads = list(idx_list), list(grads)
    nr = len(idx_list)
    if not 1 <= nr <= MAX_RADII or len(grads) != nr:
        raise ValueError(f"group_scatter: {nr} index lists, {len(grads)} "
                         f"cotangents (1 or 2 radii)")
    tensors = _build.cuda_inputs("group_scatter", *idx_list, *grads,
                                 dtypes=[_build.I32] * nr
                                 + [_build.F32_BF16] * nr)
    # rows are read as aligned 16- (f32) or 8-byte (bf16) vectors
    idx_list, grads = tensors[:nr], [_build.vector_aligned(g)
                                     for g in tensors[nr:]]
    b, m, _ = idx_list[0].shape
    c = grads[0].shape[-1]
    for idx, g in zip(idx_list, grads):
        ns = idx.shape[-1]
        if (idx.shape != (b, m, ns) or g.shape != (b, m, ns, c) or c < 3
                or not 1 <= ns <= MAX_NSAMPLE or g.dtype != grads[0].dtype):
            raise ValueError(f"group_scatter: idx {tuple(idx.shape)}, "
                             f"cotangent {tuple(g.shape)} {g.dtype}")
    ns = tuple(t.shape[-1] for t in idx_list)
    dev = grads[0].device
    points_bar = torch.empty(b, n, c, dtype=torch.float32, device=dev)
    centroid_bar = torch.empty(b, m, 3, dtype=torch.float32, device=dev)
    nbytes = _workspace_bytes(ns, b, n, m, c)
    work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    idx_arr = (ctypes.c_void_p * nr)(*(t.data_ptr() for t in idx_list))
    g_arr = (ctypes.c_void_p * nr)(*(t.data_ptr() for t in grads))
    ns_arr = (ctypes.c_int * nr)(*ns)
    P, I = _build.P, _build.I
    fn = _build.function("istnet_group_scatter",
                         [I, P, P, P, I, I, I, I, I, P, P, P,
                          ctypes.c_longlong, P])
    err = fn(nr, ctypes.cast(idx_arr, P), ctypes.cast(g_arr, P),
             ctypes.cast(ns_arr, P), b, n, m, c,
             int(grads[0].dtype == torch.bfloat16), points_bar.data_ptr(),
             centroid_bar.data_ptr(), work.data_ptr(), nbytes,
             _build.stream(points_bar))
    _build.check(err, "istnet_group_scatter")
    group_scatter_cuda.launches += 1
    return points_bar, centroid_bar


group_scatter_cuda.launches = 0
