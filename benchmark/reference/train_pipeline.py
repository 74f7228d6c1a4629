"""The published training input pipeline in plain PyTorch, batched over a
train batch of raw frames: depth completion, square crop, stratified
in-mask sampling, back-projection, the points' jitter, the NOCS target,
ColorJitter, ImageNet normalisation and the FS-Net box-stretch and rigid
augmentation (``datasets/data_utils.py``, ``aug_bbox_DZI``, ``defor_3D_bb``,
``defor_3D_rt``).

Random numbers are drawn from the step's generator in a fixed order, the
order in which the benchmark hands them to the program too: the
sampler's uniforms ``(B, S)``, the jitter's normals ``(B, S, 3)``,
ColorJitter's uniforms ``(B, 4)`` and order ``(B,)`` (an index into the 24
orders of its four operations), the augmentation's uniforms ``(B, 11)``.
ColorJitter is the float pipeline of the JAX package's port: operations
before the hue rotation compose into one affine map of ``(pixel, gray,
mean gray)``, clipped once, the hue turns once, the operations after it
compose into a second clipped map. Nothing here imports the program or JAX.
"""

from __future__ import annotations

import itertools

import torch

from .preprocess import (IMAGENET_MEAN, IMAGENET_STD, MAX_CROP, _div,
                         _resize, crop_bounds, fill_in_multiscale)

ORDERS = tuple(itertools.permutations(range(4)))
JITTER = (0.2, 0.2, 0.2, 0.05)
GRAY = (0.299, 0.587, 0.114)
SHIFT_RANGE = 0.005
S_RANGE, A_TRANS, A_ROT = (0.8, 1.2), 50.0, 15.0


def draws(b: int, s: int, g) -> dict:
    """The pipeline's draws, in order, from generator ``g``."""
    dev = g.device
    v = torch.rand(b, s, generator=g, device=dev)
    noise = torch.randn(b, s, 3, generator=g, device=dev)
    u = torch.rand(b, 4, generator=g, device=dev)
    order = torch.randint(len(ORDERS), (b,), generator=g, device=dev)
    a = torch.rand(b, 11, generator=g, device=dev)
    lo = (1 - JITTER[0], 1 - JITTER[1], 1 - JITTER[2], -JITTER[3])
    width = tuple(2 * x for x in JITTER)
    scaled = torch.stack([u[:, i] * width[i] + lo[i] for i in range(4)], 1)
    return {"v": v, "noise": noise, "factors": scaled[:, :3],
            "hue": scaled[:, 3], "order": order,
            "ex": a[:, 0:3] * (S_RANGE[1] - S_RANGE[0]) + S_RANGE[0],
            "u_bb": a[:, 3], "angles": a[:, 4:7] * (2 * A_ROT) - A_ROT,
            "aug_t": _div(a[:, 7:10] * (2 * A_TRANS) - A_TRANS, 1000.0),
            "u_rt": a[:, 10]}


def _gray(img):
    return img[..., 0] * GRAY[0] + img[..., 1] * GRAY[1] + img[..., 2] * GRAY[2]


def _compose(a, b, c, op, f):
    b2 = torch.where(op == 2, f * b + (1 - f) * (a + b), f * b)
    c2 = torch.where(op == 1, f * c + (1 - f) * (a + b + c),
                     torch.where(op == 2, c, f * c))
    return f * a, b2, c2


def _affine(img, a, b, c):
    gray = _gray(img)
    mean = gray.mean(dim=(-2, -1), keepdim=True)
    out = (a[:, None, None, None] * img
           + (b[:, None, None] * gray + c[:, None, None] * mean)[..., None])
    return out.clamp(0.0, 255.0)


def _hue(img, f):
    rgb = _div(img, 255.0)
    r, g, b = rgb.unbind(-1)
    mx, mn = rgb.amax(-1), rgb.amin(-1)
    c = mx - mn
    safe = torch.where(c > 0, c, torch.ones_like(c))
    h = torch.where(mx == r, (g - b) / safe,
                    torch.where(mx == g, 2.0 + (b - r) / safe,
                                4.0 + (r - g) / safe))
    h = torch.where(c > 0, torch.remainder(_div(h, 6.0), 1.0),
                    torch.zeros_like(h))
    s = torch.where(mx > 0, c / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    h = torch.remainder(h + f, 1.0)

    def chan(n):
        k = torch.remainder(n + h * 6.0, 6.0)
        return mx - mx * s * torch.minimum(k, 4.0 - k).clamp(0.0, 1.0)
    return (torch.stack([chan(5.0), chan(3.0), chan(1.0)], -1)
            * 255.0).clamp(0.0, 255.0)


def color_jitter(rgb, d):
    """ColorJitter(0.2, 0.2, 0.2, 0.05) of (B, H, W, 3) 0..255 images."""
    b, dev = rgb.shape[0], rgb.device
    per = torch.tensor(ORDERS, device=dev)[d["order"]]
    one, zero = torch.ones(b, device=dev), torch.zeros(b, device=dev)
    pre = suf = (one, zero, zero)
    seen = torch.zeros(b, dtype=torch.bool, device=dev)
    for step in range(4):
        op = per[:, step]
        hue = op == 3
        f = d["factors"].gather(1, op.clamp(max=2)[:, None])[:, 0]
        new_pre, new_suf = _compose(*pre, op, f), _compose(*suf, op, f)
        pre = tuple(torch.where(~seen & ~hue, n, o) for n, o in zip(new_pre, pre))
        suf = tuple(torch.where(seen & ~hue, n, o) for n, o in zip(new_suf, suf))
        seen = seen | hue
    img = _hue(_affine(rgb.float(), *pre), d["hue"][:, None, None])
    return _affine(img, *suf)


def _euler(deg):
    rad = torch.deg2rad(deg)
    cx, cy, cz = (torch.cos(rad[..., i]) for i in range(3))
    sx, sy, sz = (torch.sin(rad[..., i]) for i in range(3))
    z, o = torch.zeros_like(cx), torch.ones_like(cx)
    shape = (*cx.shape, 3, 3)
    rx = torch.stack([o, z, z, z, cx, -sx, z, sx, cx], -1).reshape(shape)
    ry = torch.stack([cy, z, sy, z, o, z, -sy, z, cy], -1).reshape(shape)
    rz = torch.stack([cz, -sz, z, sz, cz, z, z, z, o], -1).reshape(shape)
    return rz @ ry @ rx


def augment(pc, r, t, s, nocs, sym0, d, bb_pro=0.3, rt_pro=0.3):
    """The box stretch (where ``u_bb < bb_pro``), then the rigid motion
    (where ``u_rt < rt_pro``), per sample."""
    ex, ey, ez = d["ex"].unbind(-1)
    exz = (ex + ez) / 2
    sv = torch.where((sym0 == 1)[..., None], torch.stack([exz, ey, exz], -1),
                     torch.stack([ex, ey, ez], -1))
    nscale = torch.linalg.norm(s * sv, dim=-1) / torch.linalg.norm(s, dim=-1)
    pc_bb = ((pc - t[:, None]) @ r * sv[:, None]) @ r.transpose(1, 2) \
        + t[:, None]
    take = d["u_bb"] < bb_pro
    pc = torch.where(take[:, None, None], pc_bb, pc)
    s = torch.where(take[:, None], s * sv, s)
    nocs = torch.where(take[:, None, None],
                       nocs * sv[:, None] / nscale[:, None, None], nocs)
    aug_r = _euler(d["angles"])
    take = d["u_rt"] < rt_pro
    t_moved = t + d["aug_t"]
    pc = torch.where(take[:, None, None],
                     (pc + d["aug_t"][:, None]) @ aug_r.transpose(1, 2), pc)
    r = torch.where(take[:, None, None], aug_r @ r, r)
    t = torch.where(take[:, None], (aug_r @ t_moved[..., None])[..., 0], t)
    return pc, r, t, s, nocs


def prepare(raw: dict, d: dict, img: int, sample_num: int) -> dict:
    """A raw batch -> ``{"inputs", "labels"}`` of the train step."""
    depth = raw["depth_raw"].float()
    dev = depth.device
    filled = fill_in_multiscale(_div(depth, 1000.0)) * 1000.0
    b, h, w = filled.shape
    bounds = crop_bounds(raw["bbox"], h, w)
    rmin, cmin, cw = bounds[:, 0], bounds[:, 2], bounds[:, 1] - bounds[:, 0]
    valid = raw["mask_raw"].bool() & (filled > 0)
    span = torch.arange(MAX_CROP, device=dev)
    rows = (rmin[:, None] + span).clamp(max=h - 1)
    cols = (cmin[:, None] + span).clamp(max=w - 1)
    inside = span[None, :] < cw[:, None]
    bi = torch.arange(b, device=dev)
    ok = (valid[bi[:, None, None], rows[:, :, None], cols[:, None, :]]
          & inside[:, :, None] & inside[:, None, :]).reshape(b, -1)
    cdf = torch.cumsum(ok, dim=1, dtype=torch.int32)
    count = cdf[:, -1]
    slot = torch.arange(sample_num, dtype=torch.float32, device=dev)
    u = _div(slot + d["v"], sample_num) * count.float()[:, None]
    target = torch.minimum(u.floor().to(torch.int32) + 1,
                           count.clamp(min=1)[:, None])
    flat = torch.searchsorted(cdf, target).clamp(max=ok.shape[1] - 1)
    row, col = flat // MAX_CROP, flat % MAX_CROP
    pr = (rmin[:, None] + row).clamp(max=h - 1)
    pc_ = (cmin[:, None] + col).clamp(max=w - 1)
    fx, fy, cx, cy = (raw["intrinsics"][:, i][:, None].float()
                      for i in range(4))
    z = _div(filled[bi[:, None], pr, pc_], 1000.0)
    pts = torch.stack([(pc_.float() - cx) * z / fx,
                       (pr.float() - cy) * z / fy, z], dim=-1)
    pts = pts + (0.001 * d["noise"]).clamp(-SHIFT_RANGE, SHIFT_RANGE)
    r, t, s = (raw["rotation_label"].float(), raw["translation_label"].float(),
               raw["size_label"].float())
    qo = ((pts - t[:, None, :])
          / (torch.linalg.norm(s, dim=-1)[:, None, None] + 1e-8)) @ r
    ratio = torch.full_like(cw.float()[:, None], img) / cw.float()[:, None]
    choose = ((row * ratio).floor() * img + (col * ratio).floor()
              ).long().clamp(max=img * img - 1)
    crops = torch.stack([_resize(raw["rgb_raw"][i], rmin[i:i + 1],
                                 cmin[i:i + 1], cw[i:i + 1], img)[0]
                         for i in range(b)])
    rgb = color_jitter(crops, d)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    rgb = (_div(rgb, 255.0) - mean) / std
    pts, r, t, s, qo = augment(pts, r, t, s, qo, raw["sym_info"][:, 0], d)
    inputs = {"rgb": rgb, "pts": pts, "choose": choose,
              "category_label": raw["category_label"], "qo": qo}
    labels = {"rotation_label": r, "translation_label": t, "size_label": s,
              "qo": qo}
    return {"inputs": inputs, "labels": labels}
