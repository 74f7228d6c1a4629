"""The serving path's preprocessing in plain PyTorch: depth completion
(ip_basic's multiscale fill, as IST-Net's ``fill_missing`` runs it),
square crop, stratified in-mask point sampling, back-projection and the
RGB resize with ImageNet normalisation.

The semantics are those of the published data pipeline
(``datasets/data_utils.py``, ``get_bbox``, OpenCV's ``medianBlur``,
``bilateralFilter`` and ``INTER_LINEAR`` resize), batched over the
instances of one frame; the sampler takes the benchmark's uniforms ``v``
(one per stratum of the valid pixels' CDF) in place of a random choice.
Every division that a ``floor`` follows is a true float32 division.
Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

VALID = 0.01
MAX_CROP = 440
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    return x / torch.full_like(x, c)


def _dilate(x, kind: str, r: int):
    k = 2 * r + 1
    x = x[:, None]
    if kind == "full":
        out = F.max_pool2d(x, k, 1, r)
    else:
        out = torch.maximum(F.max_pool2d(x, (1, k), 1, (0, r)),
                            F.max_pool2d(x, (k, 1), 1, (r, 0)))
    return out[:, 0]


def _taps(x, offsets, mode: str):
    _, h, w = x.shape
    r = max(max(abs(dy), abs(dx)) for dy, dx in offsets)
    xp = F.pad(x[:, None], (r, r, r, r), mode=mode)[:, 0]
    return torch.stack([xp[:, r + dy:r + dy + h, r + dx:r + dx + w]
                        for dy, dx in offsets], dim=-1)


def _median5(x):
    offs = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)]
    return _taps(x, offs, "replicate").sort(dim=-1).values[..., 12]


def _bilateral5(x, sigma_color: float = 0.5, sigma_space: float = 2.0):
    offs = [(dy, dx) for dy in range(-2, 3) for dx in range(-2, 3)
            if dy * dy + dx * dx <= 4]
    space = torch.tensor([math.exp(-0.5 * (dy * dy + dx * dx)
                                   / sigma_space ** 2) for dy, dx in offs],
                         dtype=torch.float32, device=x.device)
    p = _taps(x, offs, "reflect")
    w = space * torch.exp(-0.5 * (p - x[..., None]).square() / sigma_color ** 2)
    return (w * p).sum(-1) / w.sum(-1)


def _top_mask(x):
    h = x.shape[1]
    rows = torch.arange(h, device=x.device)[None, :, None]
    first = torch.where(x > VALID, rows, h).amin(dim=1, keepdim=True)
    return rows >= torch.where(first == h, 0, first)


def fill_in_multiscale(depth: torch.Tensor, max_depth: float = 3.0):
    """(B, H, W) metres -> completed depth (ip_basic multiscale)."""
    x = depth.float()
    bands = ((x > 2.0, 1), ((x > 1.0) & (x <= 2.0), 2),
             ((x > VALID) & (x <= 1.0), 3))
    x = torch.where(x > VALID, max_depth - x, x)
    inv0, zero = x, torch.zeros((), device=x.device)
    for mask, r in bands:
        d = _dilate(torch.where(mask, inv0, zero), "cross", r)
        x = torch.where(d > VALID, d, x)
    x = -_dilate(-_dilate(x, "full", 2), "full", 2)
    x = torch.where(x > VALID, _median5(x), x)
    x = torch.where(~(x > VALID) & _top_mask(x), _dilate(x, "full", 4), x)
    top = _top_mask(x)
    for _ in range(6):
        x = torch.where((x < VALID) & top, _dilate(x, "full", 2), x)
    valid = (x > VALID) & top
    x = torch.where(valid, _median5(x), x)
    x = torch.where(valid, _bilateral5(x), x)
    return torch.where(x > VALID, max_depth - x, x)


def fill_missing(depth_mm: torch.Tensor) -> torch.Tensor:
    """(H, W) depth in mm -> completed, in mm."""
    return _div(fill_in_multiscale(_div(depth_mm[None].float(), 1000.0)),
                1.0)[0] * 1000.0


def crop_bounds(bboxes: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``get_bbox``: (K, 4) [y1, x1, y2, x2] -> [rmin, rmax, cmin, cmax]."""
    y1, x1, y2, x2 = (bboxes[:, i].long() for i in range(4))
    win = ((torch.maximum(y2 - y1, x2 - x1) // 40 + 1) * 40).clamp(max=MAX_CROP)
    rmin = (y1 + y2) // 2 - win // 2
    cmin = (x1 + x2) // 2 - win // 2
    rmax, cmax = rmin + win, cmin + win
    s = (-rmin).clamp(min=0)
    rmin, rmax = rmin + s, rmax + s
    s = (-cmin).clamp(min=0)
    cmin, cmax = cmin + s, cmax + s
    s = (rmax - h).clamp(min=0)
    rmin, rmax = rmin - s, rmax - s
    s = (cmax - w).clamp(min=0)
    cmin, cmax = cmin - s, cmax - s
    return torch.stack([rmin, rmax, cmin, cmax], dim=1)


def _resize(frame, rmin, cmin, cw, out: int):
    """cv2 INTER_LINEAR resize of each (cw, cw) window to (out, out)."""
    h, w = frame.shape[:2]
    cwf = cw.float()[:, None]
    pos = (torch.arange(out, dtype=torch.float32, device=frame.device)
           + 0.5) * _div(cwf, out) - 0.5
    pos = torch.minimum(pos.clamp(min=0.0), cwf - 1.0)
    i0 = pos.floor()
    w0 = 1.0 - (pos - i0)
    w1 = (1.0 - ((i0 + 1.0) - pos)).clamp(min=0.0)
    i0 = i0.long()
    i1 = torch.minimum(i0 + 1, cw.long()[:, None] - 1)
    r0, r1 = ((rmin[:, None] + i).clamp(max=h - 1) for i in (i0, i1))
    c0, c1 = ((cmin[:, None] + i).clamp(max=w - 1) for i in (i0, i1))

    def tap(r, c):
        return frame[r[:, :, None], c[:, None, :]].float()

    a, b = w0[:, :, None, None], w1[:, :, None, None]
    left = a * tap(r0, c0) + b * tap(r1, c0)
    right = a * tap(r0, c1) + b * tap(r1, c1)
    return w0[:, None, :, None] * left + w1[:, None, :, None] * right


def preprocess_frame(rgb, depth_mm, masks, bboxes, intrinsics, v,
                     img_size: int = 192) -> dict:
    """One frame's K instances: rgb (H, W, 3) uint8, depth_mm (H, W)
    completed, masks (K, H, W), bboxes (K, 4), intrinsics [fx, fy, cx, cy],
    v (K, S) uniforms -> the model's inputs and ``n_valid`` (K,)."""
    dev = depth_mm.device
    k, h, w = masks.shape
    s = v.shape[1]
    b = crop_bounds(bboxes, h, w)
    rmin, cmin, cw = b[:, 0], b[:, 2], b[:, 1] - b[:, 0]
    valid = masks.bool() & (depth_mm > 0)[None]
    span = torch.arange(MAX_CROP, device=dev)
    rows = (rmin[:, None] + span).clamp(max=h - 1)
    cols = (cmin[:, None] + span).clamp(max=w - 1)
    inside = span[None, :] < cw[:, None]
    ok = (valid[torch.arange(k, device=dev)[:, None, None], rows[:, :, None],
                cols[:, None, :]] & inside[:, :, None] & inside[:, None, :])
    ok = ok.reshape(k, -1)
    # stratified inverse-CDF draw of the valid cells: one per stratum
    cdf = torch.cumsum(ok, dim=1, dtype=torch.int32)
    count = cdf[:, -1]
    slot = torch.arange(s, dtype=torch.float32, device=dev)
    u = _div(slot + v.float(), s) * count.float()[:, None]
    target = torch.minimum(u.floor().to(torch.int32) + 1,
                           count.clamp(min=1)[:, None])
    flat = torch.searchsorted(cdf, target).clamp(max=ok.shape[1] - 1)
    row, col = flat // MAX_CROP, flat % MAX_CROP
    fx, fy, cx, cy = torch.as_tensor(intrinsics, dtype=torch.float32,
                                     device=dev).unbind()
    pr = (rmin[:, None] + row).clamp(max=h - 1)
    pc = (cmin[:, None] + col).clamp(max=w - 1)
    z = _div(depth_mm[pr, pc].float(), 1000.0)
    pts = torch.stack([(pc.float() - cx) * z / fx,
                       (pr.float() - cy) * z / fy, z], dim=-1)
    ratio = torch.full_like(cw.float()[:, None], img_size) / cw.float()[:, None]
    choose = ((row * ratio).floor() * img_size + (col * ratio).floor()
              ).long().clamp(max=img_size * img_size - 1)
    crop = _resize(rgb, rmin, cmin, cw, img_size)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return {"rgb": (_div(crop, 255.0) - mean) / std, "pts": pts,
            "choose": choose, "n_valid": count}
