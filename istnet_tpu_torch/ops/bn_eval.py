"""The eval BatchNorm and the op that consumes its output, in one pass
(``csrc/bn_eval.cu``): ``y = act(bn(x) [+ residual])`` over a map whose
channels are its innermost axis, in bf16 or float32.

Replaces no TPU kernel: it replaces the XLA elementwise of the JAX
package's eval BatchNorm (``istnet_tpu/nn/layers.py:151-220``), which the
port ran as about eight PyTorch launches a BN (a cast to float32, four
broadcasting passes, the rsqrt of the variance, a cast back) and one more
for the ReLU, residual add or PReLU after it.

``rows`` (4, C) float32 holds ``[running_mean, invstd, weight, bias]``
(``BatchNorm.eval_rows``); ``act`` is None, ``"relu"`` or ``"prelu"``; a
``residual`` (only with ``"relu"``) is added before the ReLU; ``slope``
(only with ``"prelu"``) is the PReLU's one-element weight. ``plain`` is
the exact expression of ``nn/layers.py::BatchNorm``'s eval branch followed
by the consumer, and the kernel computes the same bits (float32 BN, each
step rounded on its own, one rounding to x's dtype, then the consumer in
that dtype); the tests hold them equal bit for bit.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from istnet_tpu_torch.nn.layers import prelu
from istnet_tpu_torch.ops import _build

SOURCE = "istnet_tpu_torch/csrc/bn_eval.cu"
REPLACES = ("none: the XLA elementwise of istnet_tpu/nn/layers.py:151-220 "
            "(BatchNorm at eval) and its consumer")

_CODES = {None: 0, "relu": 1, "prelu": 2}     # 3: residual add + ReLU
_ARGTYPES = [_build.P] * 5 + [ctypes.c_int64] + [_build.I] * 3 + [_build.P]

__all__ = ["bn_eval_cuda", "plain"]


def plain(x: torch.Tensor, rows: torch.Tensor, act: str | None = None,
          residual: torch.Tensor | None = None,
          slope: torch.Tensor | None = None) -> torch.Tensor:
    """BatchNorm's eval expression, then its consumer in x's dtype."""
    mean, invstd, weight, bias = rows.unbind(0)
    y = (x.to(torch.float32) - mean) * invstd
    y = (y * weight + bias).to(x.dtype)
    if act == "relu":
        return F.relu(y if residual is None else y + residual)
    if act == "prelu":
        return prelu(y, slope)
    return y


def _dense_channels_last(t: torch.Tensor) -> bool:
    """True where ``t``'s elements fill its memory without gaps or overlap
    and its last axis is innermost with stride 1: an element's channel is
    then its memory offset mod C (a contiguous map, or one whose outer axes
    are permuted, as ``up_1``'s einsum leaves it)."""
    if t.is_contiguous():
        return True
    if t.stride(-1) != 1:
        return False
    expect = t.shape[-1]
    for stride, size in sorted((st, sz) for st, sz in
                               zip(t.stride()[:-1], t.shape[:-1]) if sz != 1):
        if stride != expect:
            return False
        expect *= size
    return True


def bn_eval_cuda(x: torch.Tensor, rows: torch.Tensor, act: str | None = None,
                 residual: torch.Tensor | None = None,
                 slope: torch.Tensor | None = None) -> torch.Tensor:
    """The CUDA kernel; same arguments and result as ``plain``. x (and the
    residual) bf16 or float32 on one card, rows and slope float32 there.
    The output keeps x's layout (``empty_like``); a map that is not dense
    with its channels innermost, or a residual laid out otherwise, is made
    contiguous first. Forward-only."""
    code = _CODES[act]
    if not x.is_cuda or rows.device != x.device:
        raise ValueError(f"bn_eval: every input must be on {x.device}, got "
                         f"rows on {rows.device}")
    if x.dtype not in _build.F32_BF16:
        raise TypeError(f"bn_eval: float32 or bfloat16 inputs only, got "
                        f"{x.dtype}")
    c = x.shape[-1]
    if (rows.dtype != torch.float32 or rows.shape != (4, c)
            or not rows.is_contiguous()):
        raise ValueError(f"bn_eval: rows {tuple(rows.shape)} {rows.dtype} are "
                         f"not contiguous float32 (4, {c})")
    if residual is not None:
        if act != "relu":
            raise ValueError("bn_eval: a residual goes with act='relu' only")
        if (residual.device != x.device or residual.dtype != x.dtype
                or residual.shape != x.shape):
            raise ValueError(f"bn_eval: residual {tuple(residual.shape)} "
                             f"{residual.dtype} on {residual.device} for x "
                             f"{tuple(x.shape)} {x.dtype} on {x.device}")
        code = 3
    if (act == "prelu") != (slope is not None):
        raise ValueError("bn_eval: a slope goes with act='prelu', and it "
                         "needs one")
    if slope is not None and (slope.device != x.device
                              or slope.dtype != torch.float32
                              or slope.numel() != 1):
        raise ValueError(f"bn_eval: slope {tuple(slope.shape)} {slope.dtype} "
                         f"on {slope.device} is not one float32 on "
                         f"{x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or rows.requires_grad or (
            residual is not None and residual.requires_grad) or (
            slope is not None and slope.requires_grad)):
        raise RuntimeError("bn_eval: the kernel wrapper is forward-only; call "
                           "it under torch.no_grad()")
    if not _dense_channels_last(x) or (residual is not None
                                       and residual.stride() != x.stride()):
        x = x.contiguous()
        if residual is not None:
            residual = residual.contiguous()
    out = torch.empty_like(x)
    fn = _build.function("istnet_bn_eval", _ARGTYPES)
    err = fn(x.data_ptr(), rows.data_ptr(),
             None if residual is None else residual.data_ptr(),
             None if slope is None else slope.data_ptr(),
             out.data_ptr(), x.numel(), c, code,
             int(x.dtype == torch.bfloat16), _build.stream(x))
    _build.check(err, "istnet_bn_eval")
    bn_eval_cuda.launches += 1
    return out


bn_eval_cuda.launches = 0
