"""Kernel 10: 3-nearest-neighbour search (``csrc/three_nn.cu``).

Replaces the TPU kernel ``istnet_tpu/ops/three_nn_pallas.py:
_three_nn_kernel``, which the FP backward runs to rebuild its weights. The
plain version is ``ops/pointnet2.py::three_nn``; the two give equal indices
and distances (the same arithmetic order, the search the FP interpolation
kernel runs, ``csrc/three_nn.cuh``). With ``weights=True`` the same launch
writes, in place of the distances, the normalised inverse-distance weights
that the FP backward forms from them (``three_interpolate_weights``, equal
to within float32 summation order).
"""

from __future__ import annotations

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.pointnet2 import three_interpolate_weights, three_nn

SOURCE = "istnet_tpu_torch/csrc/three_nn.cu"
REPLACES = "istnet_tpu/ops/three_nn_pallas.py:28"
MAX_KNOWN = 8192     # shared memory holds 16 bytes a known point

__all__ = ["three_nn_cuda", "plain"]


def plain(unknown: torch.Tensor, known: torch.Tensor, weights: bool = False):
    """The kernel's function in plain PyTorch: ``(dist, idx)``, or
    ``(weight, idx)`` with ``weights``."""
    dist, idx = three_nn(unknown, known)
    return (three_interpolate_weights(dist) if weights else dist), idx


def three_nn_cuda(unknown: torch.Tensor, known: torch.Tensor,
                  weights: bool = False):
    """``(B, N, 3), (B, M, 3) -> dist (B, N, 3) f32, idx (B, N, 3) int32``,
    or with ``weights`` the weights ``(B, N, 3)`` f32 in place of the
    distances; 3 <= M <= 8192."""
    unknown, known = _build.cuda_inputs("three_nn", unknown, known)
    b, n, _ = unknown.shape
    m = known.shape[1]
    if (unknown.shape[-1] != 3 or known.shape != (b, m, 3)
            or not 3 <= m <= MAX_KNOWN):
        raise ValueError(f"three_nn: unknown {tuple(unknown.shape)}, known "
                         f"{tuple(known.shape)}")
    val = torch.empty(b, n, 3, dtype=torch.float32, device=unknown.device)
    idx = torch.empty(b, n, 3, dtype=torch.int32, device=unknown.device)
    P, I = _build.P, _build.I
    fn = _build.function("istnet_three_nn", [P, P, I, I, I, P, P, I, P])
    err = fn(unknown.data_ptr(), known.data_ptr(), b, n, m, val.data_ptr(),
             idx.data_ptr(), int(weights), _build.stream(unknown))
    _build.check(err, "istnet_three_nn")
    three_nn_cuda.launches += 1
    return val, idx


three_nn_cuda.launches = 0
