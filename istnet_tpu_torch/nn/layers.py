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

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from istnet_tpu_torch.nn.precision import compute_dtype
from istnet_tpu_torch.utils.tracing import span


def cast(t: torch.Tensor | None) -> torch.Tensor | None:
    """``t`` in the compute dtype (None stays None)."""
    return None if t is None else t.to(compute_dtype())


class DerivedCache:
    """A value derived from a module's parameters and buffers (BN-folded
    and packed weights, a permuted kernel), built once and rebuilt when
    one of them changes: an entry keeps the source tensors themselves
    beside each one's storage address and version counter, so a replaced
    Parameter, ``load_state_dict``, an optimizer step, an in-place edit and
    ``.to()`` all miss it (the kept tensors stay alive, so no later
    allocation can pass for one of them); the owning module also calls
    ``clear`` from ``train()``. A write through ``.data`` moves no counter:
    follow it with ``clear`` (or ``train()``/``eval()``)."""

    def __init__(self):
        self.clear()

    def clear(self) -> None:
        self._sources, self._key, self._value = (), None, None

    def get(self, tensors, extra, build):
        """The cached value for these tensors and ``extra`` (anything
        hashable the value also depends on), built by ``build()`` if a
        tensor was replaced or the key moved."""
        tensors = tuple(tensors)
        try:
            key = (extra, tuple((t.data_ptr(), t._version) for t in tensors))
        except RuntimeError:      # inference tensors keep no version counter
            return build()
        same = len(tensors) == len(self._sources) and all(
            a is b for a, b in zip(tensors, self._sources))
        if not same or key != self._key:
            self._value, self._sources, self._key = build(), tensors, key
        return self._value


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
    (``train/train_state.py::update_bn_stats``). Under a profiler each
    forward is the span ``bn`` (``utils/tracing.py``).

    The batch variance is two-pass (``torch.var_mean``), not JAX's float32
    one-pass ``E[x^2] - E[x]^2`` (``layers.py:205-207``). The one-pass form
    cancels when |mean| >> std, and it would cancel differently here: the
    weight bridge folds the SharedMLP's dense bias into ``running_mean``
    (``convert.py``), so the port's activations are JAX's shifted by that
    bias. Two-pass is accurate at any shift; the port then differs from JAX
    by JAX's own one-pass error, which the float32 tests bound.

    Data parallel (``group``, set by ``parallel.mesh.set_batch_norm_group``,
    of more than one rank): the statistics are the global batch's, as
    JAX's are under GSPMD (``istnet_tpu/nn/layers.py:195-220``). The mean
    is the all-reduced sum over the all-reduced count, the biased variance
    the all-reduced centred sum of squares about that mean (still two-pass);
    both through the differentiable all-reduce, so the backward is the
    global-batch loss's gradient. ``batch_mean`` / ``batch_var`` are then
    the global statistics, and every rank's EMA is the same. A group of one
    rank, or none, runs the single-process code; eval uses no collective.

    ``norm_act`` is the entry of a call site whose BN output goes straight
    into a ReLU (after a residual add, where given), a PReLU or nothing: at
    eval, on a float32 or bf16 map that needs no gradient, BN and consumer
    are one pass of ``ops.bn_eval`` (the CUDA kernel on the card, the same
    expression in PyTorch on the CPU), with the same bits as the chain; the
    pass reads ``eval_rows``, built once per set of statistics and affine
    (a ``DerivedCache``, cleared by ``train()``). Training, a float64 map
    and a call that records a gradient run ``forward`` and then the
    consumer as PyTorch ops."""

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
        self.group = None
        self._rows = DerivedCache()

    def train(self, mode: bool = True):
        self._rows.clear()
        return super().train(mode)

    def eval_tensors(self) -> tuple:
        """What the eval transform is made from (a ``DerivedCache`` key)."""
        return self.weight, self.bias, self.running_mean, self.running_var

    def eval_rows(self) -> torch.Tensor:
        """(4, C) float32 ``[running_mean, invstd, weight, bias]``, the eval
        pass's constants: a normal tensor without a graph, even when first
        asked for under ``inference_mode``."""
        def build():
            with torch.inference_mode(False), torch.no_grad():
                return torch.stack([self.running_mean, self.invstd(),
                                    self.weight, self.bias])

        return self._rows.get(self.eval_tensors(), None, build)

    def norm_act(self, x: torch.Tensor, act: str | None = None,
                 residual: torch.Tensor | None = None,
                 slope: torch.Tensor | None = None) -> torch.Tensor:
        """``act(self(x) [+ residual])``: ``act`` None, ``"relu"`` (the
        residual added first, where given) or ``"prelu"`` with ``slope``,
        the PReLU's weight (``PReLU.forward``'s expression)."""
        if (self.training or x.dtype not in _PASS_DTYPES
                or (torch.is_grad_enabled() and _needs_grad(
                    x, self.weight, self.bias, residual, slope))):
            y = self(x)
            if act == "relu":
                return F.relu(y if residual is None else y + residual)
            if act == "prelu":
                return prelu(y, slope)
            return y
        # ops imports this module (the fold's plain version)
        from istnet_tpu_torch.ops import dispatch
        with span("bn"):
            return dispatch.bn_eval(x, self.eval_rows(), act, residual, slope)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("bn"):
            xs = x.to(torch.float64 if x.dtype == torch.float64
                      else torch.float32)
            if self.training:
                axes = tuple(range(x.dim() - 1))
                if self.group is not None and self.group.size() > 1:
                    mean, var, count = _global_moments(xs, axes, self.group)
                    correction = count / (count - 1).clamp(min=1)
                else:
                    var, mean = torch.var_mean(xs, dim=axes, correction=0)
                    count = x.numel() // x.shape[-1]
                    correction = count / max(count - 1, 1)
                self.batch_mean = mean.detach()
                self.batch_var = var.detach() * correction
                y = (xs - mean) * torch.rsqrt(var + self.eps)
            else:
                y = (xs - self.running_mean) * self.invstd()
            return (y * self.weight + self.bias).to(x.dtype)

    def invstd(self) -> torch.Tensor:
        return torch.rsqrt(self.running_var + self.eps)


_PASS_DTYPES = (torch.float32, torch.bfloat16)


def _needs_grad(*tensors) -> bool:
    return any(t is not None and t.requires_grad for t in tensors)


def _global_moments(xs: torch.Tensor, axes: tuple, group):
    """Mean, biased variance and row count over every rank's rows: the sum
    and the count in one all-reduce, then the centred sum of squares about
    the global mean in a second. The count stays a tensor on the device
    (no sync; exact in float32 up to 2^24 rows)."""
    from istnet_tpu_torch.parallel.collectives import all_reduce_sum

    local = xs.numel() // xs.shape[-1]
    packed = all_reduce_sum(torch.cat([xs.sum(dim=axes),
                                       xs.new_full((1,), local)]), group)
    count = packed[-1].detach()
    mean = packed[:-1] / count
    d = xs - mean
    var = all_reduce_sum((d * d).sum(dim=axes), group) / count
    return mean, var, count


class PReLU(nn.Module):
    """Single shared slope, init 0.25 (``torch.nn.PReLU()``'s key layout),
    evaluated as ``where(x >= 0, x, a * x)`` with ``a`` in the input's
    dtype (``layers.py:229``)."""

    def __init__(self, init: float = 0.25):
        super().__init__()
        self.weight = nn.Parameter(torch.full((1,), init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return prelu(x, self.weight)


def prelu(x: torch.Tensor, slope: torch.Tensor) -> torch.Tensor:
    """``where(x >= 0, x, a * x)`` with the slope ``a`` in x's dtype."""
    return torch.where(x >= 0, x, slope.to(x.dtype) * x)


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
    The backward is ``_UpsampleBilinear``'s, in a fixed order.
    """
    _, h, w, _ = x.shape
    if out_h < h or out_w < w:
        raise ValueError(f"resize_bilinear upsamples only: {h}x{w} -> "
                         f"{out_h}x{out_w}")
    y = _UpsampleBilinear.apply(x.permute(0, 3, 1, 2), out_h, out_w)
    return y.permute(0, 2, 3, 1)


def _half_pixel_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out, in) weights of align_corners=False linear upsampling, as
    PyTorch's kernel takes them: source ``(i + 0.5) * in / out - 0.5``
    clamped at 0, its two taps clamped at the edge."""
    a = np.zeros((out_size, in_size), np.float64)
    pos = np.maximum((np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5,
                     0.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    rows = np.arange(out_size)
    np.add.at(a, (rows, lo), 1.0 - (pos - lo))
    np.add.at(a, (rows, hi), pos - lo)
    return a


class _UpsampleBilinear(torch.autograd.Function):
    """``F.interpolate(bilinear, align_corners=False)`` of an NCHW map, its
    backward two contractions with the transposed interpolation matrices,
    rows first. PyTorch's own backward adds each output's share into its
    input pixels by atomics on the card, in no fixed order, so two steps
    from one state differed in their bits; the contractions sum in a fixed
    order. Under bf16 each contraction accumulates in float32 and rounds
    once to bf16, as the forward does (the policy keeps cuBLAS's bf16
    reductions in float32, ``nn/precision.py::apply_policy``)."""

    @staticmethod
    def forward(ctx, x, out_h: int, out_w: int):
        ctx.in_hw = x.shape[-2:]
        return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                             align_corners=False)

    @staticmethod
    def backward(ctx, g):
        (h, w), (out_h, out_w) = ctx.in_hw, g.shape[-2:]
        ah = _matrix_on(_half_pixel_matrix, h, out_h, g)
        aw = _matrix_on(_half_pixel_matrix, w, out_w, g)
        rows = torch.einsum("ih,ncij->nchj", ah, g)
        return torch.einsum("nchj,jw->nchw", rows, aw), None, None


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


def _matrix_on(build, in_size: int, out_size: int,
               like: torch.Tensor) -> torch.Tensor:
    """``build(in_size, out_size)`` cast to ``like``'s dtype (bf16 rounds
    the interpolation weights themselves, as JAX's ``jnp.asarray(a,
    x.dtype)``) on ``like``'s device, copied there once per shape."""
    return _cached_matrix(build, in_size, out_size, like.dtype, like.device)


@functools.lru_cache(maxsize=None)
def _cached_matrix(build, in_size: int, out_size: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference_mode, so
    # that a later training step can save it for its backward
    with torch.inference_mode(False):
        return torch.tensor(build(in_size, out_size), dtype=dtype,
                            device=device)


def resize_bilinear_align_corners(x: torch.Tensor, out_h: int,
                                  out_w: int) -> torch.Tensor:
    """align_corners=True bilinear resize of an NHWC map as two separable
    contractions with ``_interp_matrix`` (nn.Upsample(scale_factor=2,
    mode='bilinear', align_corners=True) in the reference's PSPUpsample)."""
    _, h, w, _ = x.shape
    ah = _matrix_on(_interp_matrix, h, out_h, x)
    aw = _matrix_on(_interp_matrix, w, out_w, x)
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
    s_y = _matrix_on(_shifted_interp_matrix, h, 2 * h, x)   # (2h, 3, h)
    s_x = _matrix_on(_shifted_interp_matrix, w, 2 * w, x)   # (2w, 3, w)
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
