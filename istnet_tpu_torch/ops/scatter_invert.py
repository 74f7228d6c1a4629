"""The two backward scatters' inversion on its own
(``csrc/scatter_invert.cu``, the code of ``csrc/scatter_invert.cuh``).

The grouping and the interpolation scatter run this inversion inside their
first launch; this entry runs it alone so that its result can be held to
the plain version, ``ops/pointnet2.py::invert_index``. It is no kernel of
the path of its own and keeps no launch count.
"""

from __future__ import annotations

import ctypes

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.pointnet2 import invert_index as plain

SOURCE = "istnet_tpu_torch/csrc/scatter_invert.cu"

__all__ = ["invert_index_cuda", "plain"]


def invert_index_cuda(keys: torch.Tensor, rows: int):
    """``(B, E)`` int32 keys in ``[0, rows)`` -> ``order (B, E)`` and
    ``offsets (B, rows + 1)``, int32, as ``plain``."""
    (keys,) = _build.cuda_inputs("invert_index", keys, dtypes=[_build.I32])
    b, e = keys.shape
    order = torch.empty(b, e, dtype=torch.int32, device=keys.device)
    offsets = torch.empty(b, rows + 1, dtype=torch.int32, device=keys.device)
    P, I = _build.P, _build.I
    nbytes = ctypes.c_longlong(0)
    _build.check(_build.function("istnet_invert_index_workspace",
                                 [I, I, I, P])(b, e, rows, ctypes.byref(nbytes)),
                 "istnet_invert_index_workspace")
    work = torch.empty(nbytes.value, dtype=torch.uint8, device=keys.device)
    fn = _build.function("istnet_invert_index",
                         [P, I, I, I, P, P, P, ctypes.c_longlong, P])
    err = fn(keys.data_ptr(), b, e, rows, order.data_ptr(), offsets.data_ptr(),
             work.data_ptr(), nbytes.value, _build.stream(keys))
    _build.check(err, "istnet_invert_index")
    return order, offsets
