"""Kernel 4: the fold-upsample conv (``csrc/fold_upsample.cu``):
``conv3x3(pad 1)(resize x2 align-corners(x)) + b`` with an optional
eval-BN + PReLU epilogue, for PSPUpsample's ``up_2``. One call launches the
kernel's two stages (a low-resolution GEMM into a scratch buffer, then the
interpolation with the epilogue) and counts as one launch.

Replaces the TPU kernel ``istnet_tpu/ops/fold_upsample_pallas.py:_kernel``.
The plain version is ``nn/layers.py::conv3x3_on_doubled`` followed by the
same epilogue (``plain`` below); the two agree to float32 summation order.

In bf16 (the bf16 policy's ``up_2``) x, k, the bias and the output are
bf16 and the epilogue rows stay float32. Kernel and plain version round at
the same points: the low-resolution GEMM output, the row-interpolated map,
the column-interpolated output, the bias add, the BN result and the PReLU
product; the interpolation weights themselves are rounded to bf16, as the
plain version casts its matrices to ``x.dtype`` (``layers.py:337-341``).
They differ where float32 sums taken in another order round to bf16
differently, within 1e-2 * max(1, max |plain|) on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from istnet_tpu_torch.nn.layers import _interp_matrix, conv3x3_on_doubled
from istnet_tpu_torch.ops import _build

SOURCE = "istnet_tpu_torch/csrc/fold_upsample.cu"
REPLACES = "istnet_tpu/ops/fold_upsample_pallas.py:52"

__all__ = ["fold_upsample_conv_cuda", "plain", "apply_epilogue"]


def apply_epilogue(y: torch.Tensor, epilogue: torch.Tensor) -> torch.Tensor:
    """Float32 rows ``[mean, invstd, scale, bias, alpha]``: eval BN then
    PReLU, in the order and the dtypes of ``BatchNorm`` (float32 arithmetic,
    one rounding to ``y.dtype``) and ``PReLU`` (the slope in ``y.dtype``)
    of ``nn/layers.py``."""
    mean, invstd, scale, bias, alpha = epilogue.unbind(0)
    t = (y.float() - mean) * invstd
    t = (t * scale + bias).to(y.dtype)
    return torch.where(t >= 0, t, alpha.to(y.dtype) * t)


def plain(x: torch.Tensor, k: torch.Tensor, b: torch.Tensor | None,
          epilogue: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` (B, h, w, Cin), ``k`` (3, 3, Cin, Cout) HWIO, ``b`` (Cout),
    ``epilogue`` (5, Cout) -> (B, 2h, 2w, Cout)."""
    y = conv3x3_on_doubled(x, k, b)
    return y if epilogue is None else apply_epilogue(y, epilogue)


@functools.lru_cache(maxsize=None)
def _taps(in_size: int, out_size: int, device: torch.device,
          dtype: torch.dtype = torch.float32):
    """Per output row of ``_interp_matrix(in_size, out_size)``: its two
    source rows (lo, hi) and their weights, as the plain version's cast of
    the same f64 matrix to ``dtype`` gives them (held as float32)."""
    a = _interp_matrix(in_size, out_size)
    lo = np.argmax(a > 0, axis=1)
    hi = np.minimum(lo + 1, in_size - 1)
    rows = np.arange(out_size)
    w_lo = a[rows, lo]
    w_hi = np.where(hi != lo, a[rows, hi], 0.0)
    idx = torch.tensor(np.stack([lo, hi]), dtype=torch.int32, device=device)
    w = torch.tensor(np.stack([w_lo, w_hi]), dtype=dtype).float()
    return idx, w.to(device)


def fold_upsample_conv_cuda(x: torch.Tensor, k: torch.Tensor,
                            b: torch.Tensor | None,
                            epilogue: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The CUDA kernel; same arguments and result as ``plain``: x, k and b
    all float32 or all bf16, the epilogue float32."""
    tensors = [x, k] + [t for t in (b, epilogue) if t is not None]
    like_x = (x.dtype,)
    tensors = _build.cuda_inputs(
        "fold_upsample_conv", *tensors,
        dtypes=[_build.F32_BF16, like_x] + ([] if b is None else [like_x])
        + ([] if epilogue is None else [_build.F32]))
    x, k = tensors[:2]
    rest = iter(tensors[2:])
    b = None if b is None else next(rest)
    epilogue = None if epilogue is None else next(rest)
    bsz, h, w, cin = x.shape
    cout = k.shape[-1]
    if k.shape != (3, 3, cin, cout):
        raise ValueError(f"fold_upsample_conv: k {tuple(k.shape)} is not "
                         f"(3, 3, {cin}, Cout)")
    if b is not None and b.shape != (cout,):
        raise ValueError(f"fold_upsample_conv: bias {tuple(b.shape)}")
    if epilogue is not None and epilogue.shape != (5, cout):
        raise ValueError(f"fold_upsample_conv: epilogue "
                         f"{tuple(epilogue.shape)} is not (5, {cout})")
    ylo, yw = _taps(h, 2 * h, x.device, x.dtype)
    xlo, xw = _taps(w, 2 * w, x.device, x.dtype)
    # (cin, 9*cout), columns (dy, dx, c): the low-resolution GEMM's operand
    km = k.permute(2, 0, 1, 3).reshape(cin, 9 * cout).contiguous()
    scratch = torch.empty(bsz * h * w, 9 * cout, dtype=x.dtype,
                          device=x.device)
    out = torch.empty(bsz, 2 * h, 2 * w, cout, dtype=x.dtype, device=x.device)
    P, I = _build.P, _build.I
    fn = _build.function("istnet_fold_upsample",
                         [P, P, P, P, P, P, P, P, I, I, I, I, I, P, P, I, P])
    err = fn(x.data_ptr(), km.data_ptr(),
             None if b is None else b.data_ptr(),
             None if epilogue is None else epilogue.data_ptr(),
             ylo.data_ptr(), yw.data_ptr(), xlo.data_ptr(), xw.data_ptr(),
             bsz, h, w, cin, cout, scratch.data_ptr(), out.data_ptr(),
             int(x.dtype == torch.bfloat16), _build.stream(x))
    _build.check(err, "istnet_fold_upsample")
    fold_upsample_conv_cuda.launches += 1
    return out


fold_upsample_conv_cuda.launches = 0
