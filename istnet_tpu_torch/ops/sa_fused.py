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
W is rounded to bf16 here, as the JAX wrapper rounds it. Per radius the
result is ``(B, M, c_last)`` bf16. Tolerance against the JAX kernels and
between kernel and plain version: 2e-2 * max(1, max |plain|)
(``tests/test_sa_fused.py``); the products are exact in both, so they
differ only where float32 sums taken in another order round to bf16
differently.
"""

from __future__ import annotations

import ctypes

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

__all__ = ["sa_msg_fused_cuda", "plain"]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16, as float32 values."""
    return t.to(torch.bfloat16).float()


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
    ``ns <= 64`` and one MLP depth of 1 to 4 layers."""
    radii, nsamples = tuple(radii), tuple(nsamples)
    nr = len(radii)
    depth = len(folded[0]) if folded else 0
    if (not 1 <= nr <= MAX_RADII or len(nsamples) != nr or len(folded) != nr
            or any(not 1 <= ns <= MAX_NSAMPLE for ns in nsamples)
            or not 1 <= depth <= MAX_LAYERS
            or any(len(layers) != depth for layers in folded)):
        raise ValueError(f"sa_msg_fused: radii {radii}, nsamples {nsamples}, "
                         f"MLP depths {[len(ls) for ls in folded]} (1 or 2 "
                         f"radii, ns <= {MAX_NSAMPLE}, one depth <= "
                         f"{MAX_LAYERS})")
    flat = [t for layers in folded for wb in layers for t in wb]
    geo = (xyz, new_xyz) if features is None else (xyz, new_xyz, features)
    tensors = _build.cuda_inputs(
        "sa_msg_fused", *geo, *flat,
        dtypes=[_build.F32, _build.F32, _build.BF16][:len(geo)]
        + [_build.F32] * len(flat))
    xyz, new_xyz = tensors[:2]
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    cf = 0 if features is None else tensors[2].shape[-1]
    if (xyz.shape[-1] != 3 or new_xyz.shape != (b, m, 3) or n < 1
            or (features is not None and tensors[2].shape[:2] != (b, n))):
        shape = None if features is None else tuple(features.shape)
        raise ValueError(f"sa_msg_fused: xyz {tuple(xyz.shape)}, new_xyz "
                         f"{tuple(new_xyz.shape)}, features {shape}")
    it = iter(tensors[len(geo):])
    chans, ws, bs, us, outs = [], [], [], [], []
    for _ in range(nr):
        c_in = 3 + cf
        chans.append(c_in)
        for _ in range(depth):
            w, bias = next(it), next(it)
            c_out = w.shape[-1]
            if w.shape != (c_in, c_out) or bias.shape != (c_out,):
                raise ValueError(f"sa_msg_fused: layer W {tuple(w.shape)}, "
                                 f"b {tuple(bias.shape)} after {c_in} "
                                 f"channels")
            cpad = -(-c_out // 8) * 8
            wp = torch.zeros(c_in, cpad, dtype=torch.bfloat16,
                             device=xyz.device)
            wp[:, :c_out] = w
            ws.append(wp)
            bs.append(bias)
            chans.append(c_out)
            c_in = c_out
        us.append(torch.empty(b, n, chans[-depth], dtype=torch.bfloat16,
                              device=xyz.device))
        outs.append(torch.empty(b, m, c_in, dtype=torch.bfloat16,
                                device=xyz.device))
    P, I = _build.P, _build.I
    r2 = (ctypes.c_float * nr)(*(radius_sq(r) for r in radii))
    ns_arr = (ctypes.c_int * nr)(*nsamples)
    ch_arr = (ctypes.c_int * len(chans))(*chans)
    ptrs = [(ctypes.c_void_p * len(ts))(*(t.data_ptr() for t in ts))
            for ts in (ws, bs, us, outs)]
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
