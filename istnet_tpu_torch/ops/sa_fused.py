"""Kernel 5: the fused eval SA-MSG stage (``csrc/sa_fused.cu``): ball query
+ grouping + BN-folded SharedMLP + ReLU + max over the slots, per radius.

Replaces the TPU kernel ``istnet_tpu/ops/sa_fused_pallas.py:
_sa_fused_kernel_l1`` and computes the function of its twins
``_sa_fused_kernel`` (the same MLP without the layer-1 reassociation, a
bf16-rounding difference) and ``_sa_fused_kernel_t_l1`` (stage 1: no
features, C = 3). Only the bf16 policy's eval forward runs it
(``nn/pointnet2_msg.py``), at SA stages 2-4.

``folded``: per radius, per layer ``(W (c_in, c_out), b (c_out,))`` in
float32 with eval BN folded in (``nn/pointnet2_msg.py::_fold_shared_mlp``);
W is rounded to bf16 here, as the JAX wrapper rounds it. The kernel reads
the weights in the layout of ``pack_folded`` (bf16, every width padded with
zeros to a multiple of 16: the tensor-core tile); a ``PackedFolded`` may
be handed over in place of ``folded``, and ``PointnetSAModuleMSG`` keeps one
so that folding and packing run once per set of weights and not on every
forward. Per radius the result is ``(B, M, c_last)`` bf16. Tolerance against the JAX kernels and
between kernel and plain version: 2e-2 * max(1, max |plain|)
(``tests/test_sa_fused.py``); the products are exact in both, so they
differ only where float32 sums taken in another order round to bf16
differently.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from istnet_tpu_torch.ops import _build
from istnet_tpu_torch.ops.pointnet2 import (
    _first_hits,
    group_points,
    pairwise_d2,
    radius_sq,
)

SOURCE = "istnet_tpu_torch/csrc/sa_fused.cu"
REPLACES = "istnet_tpu/ops/sa_fused_pallas.py:155"
MAX_RADII = 2
MAX_NSAMPLE = 64
MAX_LAYERS = 4

TILE = 16    # widths are padded to this: k of mma.m16n8k16, two n-tiles

__all__ = ["sa_msg_fused_cuda", "plain", "PackedFolded", "pack_folded",
           "unpack_folded"]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, as float32 values."""
    return t.to(torch.bfloat16).float()


def _ceil_tile(c: int) -> int:
    return -(-c // TILE) * TILE


@dataclasses.dataclass(frozen=True)
class PackedFolded:
    """Folded MLPs in the kernel's layout. ``chans[r]``: the true widths of
    radius r's MLP, ``(3 + cf, c_1, .., c_L)``. ``ws[r][l]``: bf16, layer 0
    ``(3 + ceil16(cf), ceil16(c_1))`` (the three xyz rows first, then the
    feature rows), layer l > 0 ``(ceil16(c_l), ceil16(c_{l+1}))``;
    ``bs[r][l]``: float32 ``(ceil16(c_{l+1}),)``; zeros in all padding."""
    chans: tuple
    ws: tuple
    bs: tuple

    @property
    def device(self) -> torch.device:
        return self.ws[0][0].device

    @functools.cached_property
    def c_args(self) -> tuple:
        """The kernel's view, made once: the depth, and ctypes arrays of
        the widths and of the weights' and biases' addresses."""
        chans = [c for ch in self.chans for c in ch]
        ws = [w for pw in self.ws for w in pw]
        bs = [b for pb in self.bs for b in pb]
        if not all(t.is_contiguous() for t in ws + bs):
            raise ValueError("sa_msg_fused: packed weights must be contiguous")
        return (len(self.ws[0]), (ctypes.c_int * len(chans))(*chans),
                (ctypes.c_void_p * len(ws))(*(w.data_ptr() for w in ws)),
                (ctypes.c_void_p * len(bs))(*(b.data_ptr() for b in bs)))


def pack_folded(folded) -> PackedFolded:
    """Round the folded weights to bf16 and pad them to the kernel's tiles.
    Pure tensor code on the weights' device; one radius's layers must chain
    (``c_out`` of a layer is ``c_in`` of the next) and all radii share the
    input width and the depth."""
    if isinstance(folded, PackedFolded):
        return folded
    chans, ws, bs = [], [], []
    for layers in folded:
        ch, pw, pb = [layers[0][0].shape[0]], [], []
        if ch[0] < 3:
            raise ValueError(f"sa_msg_fused: layer 1 takes {ch[0]} < 3 "
                             f"channels")
        for w, b in layers:
            c_in, c_out = w.shape
            if c_in != ch[-1] or b.shape != (c_out,):
                raise ValueError(f"sa_msg_fused: layer W {tuple(w.shape)}, "
                                 f"b {tuple(b.shape)} after {ch[-1]} "
                                 f"channels")
            rows = 3 + _ceil_tile(c_in - 3) if not pw else _ceil_tile(c_in)
            wp = torch.zeros(rows, _ceil_tile(c_out), dtype=torch.bfloat16,
                             device=w.device)
            wp[:c_in, :c_out] = w
            bp = torch.zeros(_ceil_tile(c_out), dtype=torch.float32,
                             device=w.device)
            bp[:c_out] = b
            pw.append(wp)
            pb.append(bp)
            ch.append(c_out)
        chans.append(tuple(ch))
        ws.append(tuple(pw))
        bs.append(tuple(pb))
    return PackedFolded(tuple(chans), tuple(ws), tuple(bs))


def unpack_folded(packed: PackedFolded) -> tuple:
    """The ``folded`` tuples a ``PackedFolded`` holds: float32 weights with
    bf16 values, the padding cut away."""
    return tuple(
        tuple((w[:c_in, :c_out].float(), b[:c_out].clone())
              for w, b, c_in, c_out in zip(pw, pb, ch[:-1], ch[1:]))
        for pw, pb, ch in zip(packed.ws, packed.bs, packed.chans))


def plain(radii, nsamples, xyz: torch.Tensor, new_xyz: torch.Tensor,
          features: torch.Tensor | None, folded) -> list:
    """The plain version: ``(B, N, 3), (B, M, 3), (B, N, Cf) or None`` ->
    per radius ``(B, M, c_last)`` bf16.

    The kernel's composition in PyTorch: the query's indices
    (``_first_hits``), ``U = bf16(vals @ W1)`` once per point, the gather
    of U minus ``cen @ W1[:3]``, later layers as float32 matmuls of
    bf16-valued operands (exact products, so CPU and card agree up to
    summation order), and the max over the slots before the last bias and
    ReLU (``sa_fused_pallas.py:198-249``)."""
    if isinstance(folded, PackedFolded):
        folded = unpack_folded(folded)
    xyz = xyz.float()
    cen = new_xyz.float()
    d2 = pairwise_d2(cen, xyz)
    vals = xyz if features is None else torch.cat([xyz, features.float()], -1)
    outs = []
    for radius, ns, layers in zip(radii, nsamples, folded):
        ws = [_bf16(w) for w, _ in layers]
        bs = [b.float() for _, b in layers]
        idx = _first_hits(d2 < radius_sq(radius), ns)
        u = _bf16(vals @ ws[0])                                # (B, N, c1)
        z = group_points(u, idx) - (cen @ ws[0][:3])[:, :, None, :]
        for w, b in zip(ws[1:], bs):
            z = _bf16(torch.relu(z + b)) @ w
        outs.append(torch.relu(z.amax(dim=2) + bs[-1]).to(torch.bfloat16))
    return outs


def sa_msg_fused_cuda(radii, nsamples, xyz: torch.Tensor,
                      new_xyz: torch.Tensor, features: torch.Tensor | None,
                      folded) -> list:
    """The CUDA kernel; same arguments and result as ``plain``. xyz and
    the centroids float32, features bf16 or None; 1 or 2 radii with
    ``ns <= 64`` and one MLP depth of 1 to 4 layers; ``folded`` as tuples
    (packed here, on the fly) or a ``PackedFolded`` on the same device."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    nr = len(radii)
    packed = pack_folded(folded)
    depth = len(packed.ws[0]) if packed.ws else 0
    if (not 1 <= nr <= MAX_RADII or len(nsamples) != nr
            or len(packed.ws) != nr
            or any(not 1 <= ns <= MAX_NSAMPLE for ns in nsamples)
            or not 1 <= depth <= MAX_LAYERS
            or any(len(ws) != depth for ws in packed.ws)):
        raise ValueError(f"sa_msg_fused: radii {radii}, nsamples {nsamples}, "
                         f"MLP depths {[len(ws) for ws in packed.ws]} (1 or 2 "
                         f"radii, ns <= {MAX_NSAMPLE}, one depth <= "
                         f"{MAX_LAYERS})")
    geo = (xyz, new_xyz) if features is None else (xyz, new_xyz, features)
    tensors = _build.cuda_inputs(
        "sa_msg_fused", *geo,
        dtypes=[_build.F32, _build.F32, _build.BF16][:len(geo)])
    xyz, new_xyz = tensors[:2]
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    cf = 0 if features is None else tensors[2].shape[-1]
    if (xyz.shape[-1] != 3 or new_xyz.shape != (b, m, 3) or n < 1
            or (features is not None and tensors[2].shape[:2] != (b, n))):
        shape = None if features is None else tuple(features.shape)
        raise ValueError(f"sa_msg_fused: xyz {tuple(xyz.shape)}, new_xyz "
                         f"{tuple(new_xyz.shape)}, features {shape}")
    if any(ch[0] != 3 + cf for ch in packed.chans):
        raise ValueError(f"sa_msg_fused: layer 1 takes "
                         f"{[ch[0] for ch in packed.chans]} channels, the "
                         f"points carry 3 + {cf}")
    if packed.device != xyz.device:
        raise ValueError(f"sa_msg_fused: weights on {packed.device}, points "
                         f"on {xyz.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for ts in packed.ws + packed.bs for t in ts):
        raise RuntimeError("sa_msg_fused: the kernel wrapper is forward-only; "
                           "call it under torch.no_grad()")
    us = [torch.empty(b, n, pw[0].shape[1], dtype=torch.bfloat16,
                      device=xyz.device) for pw in packed.ws]
    outs = [torch.empty(b, m, ch[-1], dtype=torch.bfloat16, device=xyz.device)
            for ch in packed.chans]
    P, I = _build.P, _build.I
    _, ch_arr, w_arr, b_arr = packed.c_args
    r2 = (ctypes.c_float * nr)(*(radius_sq(r) for r in radii))
    ns_arr = (ctypes.c_int * nr)(*nsamples)
    ptrs = [w_arr, b_arr] + [
        (ctypes.c_void_p * nr)(*(t.data_ptr() for t in ts))
        for ts in (us, outs)]
    fn = _build.function("istnet_sa_fused",
                         [P, P, P, I, I, I, I, I, P, P, I, P, P, P, P, P, P])
    err = fn(xyz.data_ptr(), new_xyz.data_ptr(),
             None if features is None else tensors[2].data_ptr(),
             b, n, m, cf, nr, ctypes.cast(r2, P), ctypes.cast(ns_arr, P),
             depth, ctypes.cast(ch_arr, P),
             *(ctypes.cast(a, P) for a in ptrs), _build.stream(xyz))
    _build.check(err, "istnet_sa_fused")
    sa_msg_fused_cuda.launches += 1
    return outs


sa_msg_fused_cuda.launches = 0
