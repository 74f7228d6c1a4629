"""The FP backward's scatter (``csrc/interp_scatter.cu``).

The body of the TPU FP backward ``istnet_tpu/ops/three_nn_pallas.py:
_fpi_bwd`` (an interpolation-matrix einsum there), run right after kernel
10. The plain version is ``ops/pointnet2.py::three_interpolate_grad``. The
kernel inverts the neighbour indices on the card and lets each known point
gather its weighted cotangent rows in a fixed order
(``csrc/scatter_invert.cuh``): no atomic add into the output, so two calls
give the same bits, and its sums agree with the plain version's to f32
summation order. One call makes two launches and counts one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.pointnet2 import three_interpolate_grad as plain

SOURCE = "istnet_tpu_torch/csrc/interp_scatter.cu"
REPLACES = "istnet_tpu/ops/three_nn_pallas.py:213"

__all__ = ["interp_scatter_cuda", "plain"]


@functools.lru_cache(maxsize=64)
def _workspace_bytes(b: int, n: int, m: int, c: int) -> int:
    nbytes = ctypes.c_longlong(0)
    fn = _build.function("istnet_interp_scatter_workspace",
                         [_build.I] * 4 + [_build.P])
    _build.check(fn(b, n, m, c, ctypes.byref(nbytes)),
                 "istnet_interp_scatter_workspace")
    return nbytes.value


def interp_scatter_cuda(grad: torch.Tensor, idx: torch.Tensor,
                        weight: torch.Tensor, m: int) -> torch.Tensor:
    """``(B, N, C)`` float32 or bf16 cotangent, ``(B, N, 3)`` int32
    indices into ``M`` known points and ``(B, N, 3)`` float32 weights ->
    ``(B, M, C)`` float32."""
    grad, idx, weight = _build.cuda_inputs(
        "interp_scatter", grad, idx, weight,
        dtypes=[_build.F32_BF16, _build.I32, _build.F32])
    grad = _build.vector_aligned(grad)    # rows read as aligned vectors
    b, n, c = grad.shape
    if idx.shape != (b, n, 3) or weight.shape != (b, n, 3) or m < 1:
        raise ValueError(f"interp_scatter: grad {tuple(grad.shape)}, idx "
                         f"{tuple(idx.shape)}, weight {tuple(weight.shape)}, "
                         f"m {m}")
    out = torch.empty(b, m, c, dtype=torch.float32, device=grad.device)
    nbytes = _workspace_bytes(b, n, m, c)
    work = torch.empty(nbytes, dtype=torch.uint8, device=grad.device)
    P, I = _build.P, _build.I
    fn = _build.function("istnet_interp_scatter",
                         [P, P, P, I, I, I, I, I, P, P, ctypes.c_longlong, P])
    err = fn(grad.data_ptr(), idx.data_ptr(), weight.data_ptr(), b, n, m, c,
             int(grad.dtype == torch.bfloat16), out.data_ptr(),
             work.data_ptr(), nbytes, _build.stream(grad))
    _build.check(err, "istnet_interp_scatter")
    interp_scatter_cuda.launches += 1
    return out


interp_scatter_cuda.launches = 0
