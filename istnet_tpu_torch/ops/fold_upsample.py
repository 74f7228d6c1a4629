"""Kernel 4: the fold-upsample conv (``csrc/fold_upsample.cu``):
``conv3x3(pad 1)(resize x2 align-corners(x)) + b`` with an optional
eval-BN + PReLU epilogue, for PSPUpsample's ``up_2``. One call launches the
kernel's two stages (a low-resolution GEMM into a scratch buffer, on the
tensor cores in bf16 and on the CUDA cores in float32, then the separable
interpolation with the epilogue) and counts as one launch. The GEMM reads
the weight as ``pack_kernel`` lays it out (zero-padded to the block tile);
``PSPUpsample`` keeps a ``PackedFold`` per set of weights and hands it over
in place of ``k``, so the permute, the padding and the epilogue rows are
built once and not on every forward.

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

import dataclasses
import functools

import numpy as np
import torch

from istnet_tpu_torch.nn.layers import _interp_matrix, conv3x3_on_doubled
from istnet_tpu_torch.ops import _build

SOURCE = "istnet_tpu_torch/csrc/fold_upsample.cu"
REPLACES = "istnet_tpu/ops/fold_upsample_pallas.py:52"

CH_TILE = 8      # output channels are padded to this (16-byte vectors)
N_TILE = 192     # the GEMM's block tile along its 9 * cout columns
K_TILE = {torch.float32: 32, torch.bfloat16: 64}   # its depth is padded to this

__all__ = ["fold_upsample_conv_cuda", "plain", "apply_epilogue",
           "PackedFold", "pack_fold", "pack_kernel", "unpack_kernel"]


def apply_epilogue(y: torch.Tensor, epilogue: torch.Tensor) -> torch.Tensor:
    """Float32 rows ``[mean, invstd, scale, bias, alpha]``: eval BN then
    PReLU, in the order and the dtypes of ``BatchNorm`` (float32 arithmetic,
    one rounding to ``y.dtype``) and ``PReLU`` (the slope in ``y.dtype``)
    of ``nn/layers.py``."""
    mean, invstd, scale, bias, alpha = epilogue.unbind(0)
    t = (y.float() - mean) * invstd
    t = (t * scale + bias).to(y.dtype)
    return torch.where(t >= 0, t, alpha.to(y.dtype) * t)


def _ceil(c: int, tile: int) -> int:
    return -(-c // tile) * tile


@dataclasses.dataclass(frozen=True)
class PackedFold:
    """One fold's constants as the kernel reads them: ``km`` with
    ``km[ci, (3 dy + dx) * coutp + c] = k[dy, dx, ci, c]`` and zeros
    elsewhere, ``(Kp, Np)`` in float32 and its transpose ``(Np, Kp)`` in
    bf16, where the tensor cores read both operands along the depth
    (``coutp`` = Cout rounded up to 8, ``Np`` = 9 coutp rounded up to 192,
    ``Kp`` = Cin rounded up to 32 in float32 and to 64 in bf16), beside the
    HWIO kernel, the bias and the epilogue rows it was made from (the plain
    version's)."""
    km: torch.Tensor
    k: torch.Tensor
    b: torch.Tensor | None
    epilogue: torch.Tensor | None


def pack_kernel(k: torch.Tensor) -> torch.Tensor:
    """``k`` (3, 3, Cin, Cout) HWIO -> the GEMM operand ``km`` of
    ``PackedFold``, in ``k``'s dtype. Pure tensor code."""
    _, _, cin, cout = k.shape
    coutp = _ceil(cout, CH_TILE)
    km = torch.zeros(_ceil(cin, K_TILE[k.dtype]), 9, coutp, dtype=k.dtype,
                     device=k.device)
    km[:cin, :, :cout] = k.permute(2, 0, 1, 3).reshape(cin, 9, cout)
    km = torch.nn.functional.pad(km.flatten(1), (0, _ceil(9 * coutp, N_TILE)
                                                 - 9 * coutp))
    return km.t().contiguous() if k.dtype == torch.bfloat16 else km


def unpack_kernel(km: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """The HWIO kernel a ``pack_kernel`` result holds."""
    coutp = _ceil(cout, CH_TILE)
    if km.dtype == torch.bfloat16:
        km = km.t()
    return (km[:cin, :9 * coutp].reshape(cin, 3, 3, coutp)[..., :cout]
            .permute(1, 2, 0, 3).contiguous())


def pack_fold(k: torch.Tensor, b: torch.Tensor | None,
              epilogue: torch.Tensor | None = None) -> PackedFold:
    """Check one fold's constants against each other (k float32 or bf16
    HWIO, b of k's dtype, the epilogue float32, one device) and pack k."""
    cout = k.shape[-1]
    if k.dim() != 4 or k.shape[:2] != (3, 3):
        raise ValueError(f"fold_upsample_conv: k {tuple(k.shape)} is not "
                         f"(3, 3, Cin, Cout)")
    if k.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fold_upsample_conv: float32 or bfloat16 inputs "
                        f"only, got {k.dtype}")
    if b is not None and (b.shape != (cout,) or b.dtype != k.dtype):
        raise ValueError(f"fold_upsample_conv: bias {tuple(b.shape)} "
                         f"{b.dtype} for k {tuple(k.shape)} {k.dtype}")
    if epilogue is not None and (epilogue.shape != (5, cout)
                                 or epilogue.dtype != torch.float32):
        raise ValueError(f"fold_upsample_conv: epilogue "
                         f"{tuple(epilogue.shape)} {epilogue.dtype} is not "
                         f"float32 (5, {cout})")
    if any(t is not None and t.device != k.device for t in (b, epilogue)):
        raise ValueError("fold_upsample_conv: k, bias and epilogue on "
                         "different devices")
    return PackedFold(pack_kernel(k),
                      k, None if b is None else b.contiguous(),
                      None if epilogue is None else epilogue.contiguous())


def plain(x: torch.Tensor, k, b: torch.Tensor | None = None,
          epilogue: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` (B, h, w, Cin), ``k`` (3, 3, Cin, Cout) HWIO, ``b`` (Cout),
    ``epilogue`` (5, Cout) -> (B, 2h, 2w, Cout); or ``k`` a ``PackedFold``
    that carries all three."""
    if isinstance(k, PackedFold):
        k, b, epilogue = k.k, k.b, k.epilogue
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


def fold_upsample_conv_cuda(x: torch.Tensor, k, b: torch.Tensor | None = None,
                            epilogue: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """The CUDA kernel; same arguments and result as ``plain``: x, k and b
    all float32 or all bf16, the epilogue float32."""
    packed = k if isinstance(k, PackedFold) else pack_fold(k, b, epilogue)
    km, k, b, epilogue = packed.km, packed.k, packed.b, packed.epilogue
    (x,) = _build.cuda_inputs("fold_upsample_conv", x,
                              dtypes=[_build.F32_BF16])
    bsz, h, w, cin = x.shape
    cout = k.shape[-1]
    if k.shape[2] != cin or km.device != x.device:
        raise ValueError(f"fold_upsample_conv: k {tuple(k.shape)} on "
                         f"{km.device} for x {tuple(x.shape)} on {x.device}")
    if k.dtype != x.dtype:
        raise TypeError(f"fold_upsample_conv: k {k.dtype} for x {x.dtype}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (k, b, epilogue)):
        raise RuntimeError("fold_upsample_conv: the kernel wrapper is "
                           "forward-only; call it under torch.no_grad()")
    coutp = _ceil(cout, CH_TILE)
    lda = _ceil(cin, CH_TILE)
    if lda != cin:      # rows of x must be 16-byte aligned for the GEMM
        x = torch.nn.functional.pad(x, (0, lda - cin))
    ylo, yw = _taps(h, 2 * h, x.device, x.dtype)
    xlo, xw = _taps(w, 2 * w, x.device, x.dtype)
    scratch = torch.empty(bsz * h * w, 9 * coutp, dtype=x.dtype,
                          device=x.device)
    out = torch.empty(bsz, 2 * h, 2 * w, cout, dtype=x.dtype, device=x.device)
    kp, np_ = km.shape[::-1] if x.dtype == torch.bfloat16 else km.shape
    P, I = _build.P, _build.I
    fn = _build.function("istnet_fold_upsample",
                         [P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P,
                          P, I, P])
    err = fn(x.data_ptr(), km.data_ptr(),
             None if b is None else b.data_ptr(),
             None if epilogue is None else epilogue.data_ptr(),
             ylo.data_ptr(), yw.data_ptr(), xlo.data_ptr(), xw.data_ptr(),
             bsz, h, w, lda, kp, cout, coutp, np_,
             scratch.data_ptr(), out.data_ptr(),
             int(x.dtype == torch.bfloat16), _build.stream(x))
    _build.check(err, "istnet_fold_upsample")
    fold_upsample_conv_cuda.launches += 1
    return out


fold_upsample_conv_cuda.launches = 0
