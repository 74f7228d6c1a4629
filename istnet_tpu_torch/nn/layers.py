"""Primitive layers: convs on channel-last data, BatchNorm, PReLU,
Dropout2d, resizes and the fold-upsample conv's plain version.

Counterpart of ``istnet_tpu/nn/layers.py``. Activations are channel-last
throughout (NHWC maps, ``(B, N, C)`` points), as in the JAX package.
Parameters keep the reference torch layouts (``Conv2d`` weights OIHW, 1x1
point convs ``(O, I, 1[, 1])``) so that state dicts use the reference keys;
a convolution runs on an NHWC tensor through a permuted NCHW view, which
cuDNN takes as the channels-last memory format without a copy.

Dtypes follow the compute policy (``nn/precision.py``) explicitly, where
the JAX layer casts, not through ``torch.autocast``: convs and dense layers
cast input, weight and bias to the compute dtype on each call (parameters
stay float32); BatchNorm computes in float32 and casts back to its input's
dtype; PReLU casts its slope to the input's dtype; the interpolation
matrices of the resizes are cast to the map's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from istnet_tpu_torch.nn.precision import compute_dtype


def cast(t: torch.Tensor | None) -> torch.Tensor | None:
    """``t`` in the compute dtype (None stays None)."""
    return None if t is None else t.to(compute_dtype())


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """Apply ``conv`` (its weight, bias, stride, padding) to an NHWC map, in
    the compute dtype (``istnet_tpu/nn/layers.py:106-113``)."""
    y = F.conv2d(cast(x).permute(0, 3, 1, 2), cast(conv.weight),
                 cast(conv.bias), conv.stride, conv.padding, conv.dilation)
    return y.permute(0, 2, 3, 1)


def pointwise(x: torch.Tensor, conv: nn.Module) -> torch.Tensor:
    """A 1x1 conv (``Conv1d``/``Conv2d`` weight ``(O, I, 1[, 1])``) or a
    ``Linear`` on the last axis of channel-last data: one matmul in the
    compute dtype (``istnet_tpu/nn/layers.py:140-148``)."""
    return F.linear(cast(x), cast(conv.weight.flatten(1)), cast(conv.bias))


class BatchNorm(nn.Module):
    """BatchNorm over the last axis, ``istnet_tpu/nn/layers.py::BatchNorm``:
    ``(x - mean) * rsqrt(var + eps) * weight + bias`` in that order, in
    float32 (float64 for float64 inputs) with one rounding back to the
    input's dtype (``layers.py:219-220``). The parameter and buffer names
    are those of ``torch.nn.BatchNorm2d``.

    Eval uses the running statistics. Train mode normalises with the batch
    mean and the biased batch variance over every axis but the last, and
    publishes this step's batch mean and unbiased variance as
    ``batch_mean`` / ``batch_var`` (JAX's ``bn_batch`` collection). The
    forward never touches ``running_*``: the train step applies the EMA
    with the scheduled momentum after the update
    (``train/train_state.py::update_bn_stats``).

    The batch variance is two-pass (``torch.var_mean``), not JAX's float32
    one-pass ``E[x^2] - E[x]^2`` (``layers.py:205-207``). The one-pass form
    cancels when |mean| >> std, and it would cancel differently here: the
    weight bridge folds the SharedMLP's dense bias into ``running_mean``
    (``convert.py``), so the port's activations are JAX's shifted by that
    bias. Two-pass is accurate at any shift; the port then differs from JAX
    by JAX's own one-pass error, which the float32 tests bound."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))
        self.batch_mean: torch.Tensor | None = None
        self.batch_var: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.to(torch.float64 if x.dtype == torch.float64 else torch.float32)
        if self.training:
            axes = tuple(range(x.dim() - 1))
            var, mean = torch.var_mean(xs, dim=axes, correction=0)
            count = x.numel() // x.shape[-1]
            self.batch_mean = mean.detach()
            self.batch_var = var.detach() * (count / max(count - 1, 1))
            y = (xs - mean) * torch.rsqrt(var + self.eps)
        else:
            y = (xs - self.running_mean) * self.invstd()
        return (y * self.weight + self.bias).to(x.dtype)

    def invstd(self) -> torch.Tensor:
        return torch.rsqrt(self.running_var + self.eps)


class PReLU(nn.Module):
    """Single shared slope, init 0.25 (``torch.nn.PReLU()``'s key layout),
    evaluated as ``where(x >= 0, x, a * x)`` with ``a`` in the input's
    dtype (``layers.py:229``)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class Dropout2d(nn.Module):
    """Channel dropout for NHWC maps (torch ``nn.Dropout2d``;
    ``istnet_tpu/nn/layers.py:232-257``): in training, ``x`` times a
    ``(B, 1, 1, C)`` keep mask scaled by ``1 / keep``, zeros at ``rate >=
    1``; the identity at eval. The mask is drawn from the
    ``torch.Generator`` the caller passes (the train step's), never from
    the global one; JAX draws other bits, and dropout has no golden-value
    contract, so the parity tests turn it off."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        if generator is None:
            raise ValueError("Dropout2d in training draws its mask from an "
                             "explicit torch.Generator; pass one")
        keep = 1.0 - self.rate
        b, c = x.shape[0], x.shape[-1]
        draw = torch.rand((b, 1, 1, c), generator=generator,
                          device=generator.device)
        mask = (draw < keep).to(device=x.device, dtype=x.dtype)
        return x * (mask * (1.0 / keep))


# ---------------------------------------------------------------------------
# Resizing
# ---------------------------------------------------------------------------

def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """align_corners=False bilinear upsampling of an NHWC map.

    Equals ``jax.image.resize(..., "bilinear")`` when upsampling (both use
    half-pixel centres and clamp at the edges); the two differ when
    downsampling (JAX antialiases), which PSP never does, so that raises.
    """
    _, h, w, _ = x.shape
    if out_h < h or out_w < w:
        raise ValueError(f"resize_bilinear upsamples only: {h}x{w} -> "
                         f"{out_h}x{out_w}")
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def _interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) align-corners linear interpolation matrix, built in f64
    (``istnet_tpu/nn/layers.py:270-291``; callers cast it)."""
    a = np.zeros((out_size, in_size), np.float64)
    if in_size == 1:
        a[:, 0] = 1.0
        return a
    pos = np.linspace(0.0, in_size - 1.0, out_size)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = pos - lo
    rows = np.arange(out_size)
    np.add.at(a, (rows, lo), 1.0 - w)
    np.add.at(a, (rows, hi), w)
    return a


def _as_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """``a`` cast to ``like``'s dtype (bf16 rounds the interpolation
    weights themselves, as JAX's ``jnp.asarray(a, x.dtype)``)."""
    return torch.tensor(a, dtype=like.dtype, device=like.device)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of an NHWC map as two separable
    contractions with ``_interp_matrix`` (nn.Upsample(scale_factor=2,
    mode='bilinear', align_corners=True) in the reference's PSPUpsample)."""
    _, h, w, _ = x.shape
    ah = _as_tensor(_interp_matrix(h, out_h), x)
    aw = _as_tensor(_interp_matrix(w, out_w), x)
    y = torch.einsum("ih,bhwc->biwc", ah, x)
    return torch.einsum("jw,biwc->bijc", aw, y)


def _shifted_interp_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, 3, in): the align-corners matrix shifted by the three 3x3-conv
    row taps, zero rows for the conv's zero padding:
    ``S[i, dy] = A[i + dy - 1]`` (zeros outside [0, out))."""
    a = _interp_matrix(in_size, out_size)
    a_pad = np.concatenate([np.zeros((1, in_size)), a,
                            np.zeros((1, in_size))], axis=0)
    return np.stack([a_pad[d:d + out_size] for d in range(3)], axis=1)


def conv3x3_on_doubled(x: torch.Tensor, k: torch.Tensor,
                       b: torch.Tensor | None) -> torch.Tensor:
    """``conv3x3(pad=1)(resize_bilinear_align_corners(x, 2h, 2w)) + b``
    computed at the low resolution (``istnet_tpu/nn/layers.py:320-341``):
    one ``(Cin, 9*Cout)`` matmul per low-res pixel, then the x2 resize folded
    into the shifted separable interpolation matrices. Exact up to float
    reassociation; 4x fewer conv FLOPs than convolving the doubled map.

    This is the plain version of the fold-upsample kernel
    (``ops/fold_upsample.py``). ``x`` (B, h, w, Cin); ``k`` (3, 3, Cin, Cout)
    HWIO; returns (B, 2h, 2w, Cout). ``x``, ``k`` and ``b`` share one dtype;
    in bf16 each contraction accumulates in float32 and rounds once, and
    the bias add rounds again.
    """
    bsz, h, w, cin = x.shape
    cout = k.shape[-1]
    km = k.permute(2, 0, 1, 3).reshape(cin, 9 * cout)
    y = (x.reshape(-1, cin) @ km).reshape(bsz, h, w, 3, 3, cout)
    s_y = _as_tensor(_shifted_interp_matrix(h, 2 * h), x)   # (2h, 3, h)
    s_x = _as_tensor(_shifted_interp_matrix(w, 2 * w), x)   # (2w, 3, w)
    t = torch.einsum("idh,bhwdec->biwec", s_y, y)
    out = torch.einsum("jew,biwec->bijc", s_x, t)
    return out if b is None else out + b


def adaptive_avg_pool(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """NHWC adaptive average pool to (out_size, out_size); divisible sizes
    only (PSP sees 24x24 at the 192 crop and pools to 1/2/3/6)."""
    b, h, w, c = x.shape
    if h % out_size or w % out_size:
        raise ValueError(f"adaptive_avg_pool needs divisible sizes, got "
                         f"{h}x{w} -> {out_size}")
    kh, kw = h // out_size, w // out_size
    return x.reshape(b, out_size, kh, out_size, kw, c).mean(dim=(2, 4))
