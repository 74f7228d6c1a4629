"""The general traffic generator: pools of frames, crop batches and train
batches made from a run's seed and a traffic file's parameters.

Every seed gets the same set of sizes in another order: the number of
instances a frame, the hole shares and the tiny masks are a fixed
stratified set permuted by the seed, so that seeds change the pixels and
the order, not the amount of work. Frames are the synthetic raw RGB-D
frames of the port's ``entry.make_frame`` (a slanted surface, a box per
instance in front of it, holes and an empty band at the top), drawn here
from the benchmark's own generator.
"""

from __future__ import annotations

import numpy as np

FRAME_H, FRAME_W = 480, 640
REAL_INTRINSICS = (591.0125, 590.16775, 322.525, 244.11084)


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), stream])


def bucket(n: int, max_bucket: int) -> int:
    """The serving loop's padded batch: the next power of two, capped."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_bucket)


def stratified(lo: float, hi: float, n: int, g) -> np.ndarray:
    """``n`` values evenly spread over [lo, hi], in an order from ``g``."""
    return g.permutation(np.linspace(lo, hi, n))


def instance_counts(t: dict, g) -> np.ndarray:
    """Instances of each pool frame: ``k_min..k_max`` in equal shares."""
    ks = np.arange(t["pool"]) % (t["k_max"] - t["k_min"] + 1) + t["k_min"]
    return g.permutation(ks)


def tiny_flags(counts, share: float, g) -> list[np.ndarray]:
    """Which instances get a tiny mask: ``round(share * total)`` of them."""
    total = int(sum(counts))
    flags = np.zeros(total, bool)
    flags[g.choice(total, int(round(share * total)), replace=False)] = True
    return np.split(flags, np.cumsum(counts)[:-1])


def make_frame(g, k: int, tiny: np.ndarray, hole_share: float) -> dict:
    """A raw frame with ``k`` instances; instance ``i`` has a 3 x 3 mask
    where ``tiny[i]`` (fewer valid pixels than the loops' ``min_points``)."""
    yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W].astype(np.float32)
    depth = 1400.0 + 0.5 * xx + 0.8 * yy
    masks = np.zeros((k, FRAME_H, FRAME_W), bool)
    bboxes = np.zeros((k, 4), np.int32)
    cols = max(1, int(np.ceil(np.sqrt(k * FRAME_W / FRAME_H))))
    rows = -(-k // cols)
    cell_h, cell_w = (FRAME_H - 80) // rows, FRAME_W // cols
    for i in range(k):
        size = 3 if tiny[i] else int(g.integers(
            40, max(41, min(cell_h, cell_w) - 8)))
        y0 = 80 + (i // cols) * cell_h + int(g.integers(0, cell_h - size))
        x0 = (i % cols) * cell_w + int(g.integers(0, cell_w - size))
        masks[i, y0:y0 + size, x0:x0 + size] = True
        bboxes[i] = (y0, x0, y0 + size, x0 + size)
        depth[y0:y0 + size, x0:x0 + size] = (
            700.0 + 60.0 * i + 0.3 * xx[y0:y0 + size, x0:x0 + size])
    depth[g.random((FRAME_H, FRAME_W)) < hole_share] = 0.0
    depth[:60] = 0.0
    for i in np.flatnonzero(tiny):           # tiny masks keep their depth
        y0, x0 = bboxes[i, :2]
        depth[y0:y0 + 3, x0:x0 + 3] = 700.0 + 60.0 * i
    return {"rgb_full": g.integers(0, 256, (FRAME_H, FRAME_W, 3),
                                   dtype=np.uint8),
            "depth_raw": depth.astype(np.float32), "masks": masks,
            "bboxes": bboxes,
            "category_label": g.integers(0, 6, k).astype(np.int64)}


def pad_frame(frame: dict, size: int) -> dict:
    """Pad the instances to ``size`` rows as the serving loop does: empty
    masks (so ``n_valid`` is 0 and the row is dropped), the last box,
    class 0."""
    pad = size - frame["masks"].shape[0]
    if pad <= 0:
        return frame
    m, b, c = frame["masks"], frame["bboxes"], frame["category_label"]
    return {**frame,
            "masks": np.concatenate([m, np.zeros((pad,) + m.shape[1:], bool)]),
            "bboxes": np.concatenate([b, np.tile(b[-1:], (pad, 1))]),
            "category_label": np.concatenate([c, np.zeros(pad, c.dtype)])}


def frame_pool(t: dict, seed: int) -> list[dict]:
    """The pool of ``t["pool"]`` frames, each padded to its bucket, with
    ``k`` (its instances) beside the arrays."""
    g = rng(seed, 1)
    counts = instance_counts(t, g)
    holes = stratified(t["hole_min"], t["hole_max"], t["pool"], g)
    tiny = tiny_flags(counts, t["tiny_share"], g)
    pool = []
    for k, h, ty in zip(counts, holes, tiny):
        f = pad_frame(make_frame(g, int(k), ty, float(h)),
                      bucket(int(k), t["max_bucket"]))
        pool.append({**f, "k": int(k)})
    return pool


def box_clouds(b: int, n: int, gen, device) -> dict:
    """Object clouds as a depth camera sees them: ``n`` points on the
    surface of a box of sides ``U(0.05, 0.3)`` m (a face chosen in
    proportion to its area), jittered by ``N(0, 1 mm)``, turned by a random
    rotation (orthonormalised normals, determinant 1) and placed at
    ``N(0, 0.1) + (0, 0, 1)`` m; with the pose labels and the NOCS points
    ``qo = (pts - t) / |s| @ R``."""
    import torch

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    size = 0.05 + 0.25 * rand(b, 3)
    sx, sy, sz = size.unbind(-1)
    area = torch.stack([sy * sz, sy * sz, sx * sz, sx * sz, sx * sy, sx * sy],
                       -1)
    face = torch.multinomial(area, n, replacement=True, generator=gen)
    axis = face // 2                                          # fixed axis
    sign = (face % 2).float() * 2.0 - 1.0
    local = (rand(b, n, 3) - 0.5) * size[:, None, :]
    fixed = torch.nn.functional.one_hot(axis, 3).bool()
    local = torch.where(fixed, sign[..., None] * 0.5 * size[:, None, :],
                        local)
    q, r = torch.linalg.qr(randn(b, 3, 3))
    rot = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    rot[..., 2] *= torch.sign(torch.linalg.det(rot))[:, None]
    t = 0.1 * randn(b, 3)
    t[:, 2] += 1.0
    pts = local @ rot.transpose(1, 2) + t[:, None, :] + 0.001 * randn(b, n, 3)
    qo = (pts - t[:, None, :]) / torch.linalg.norm(size, dim=-1)[:, None, None]
    return {"pts": pts, "qo": qo @ rot, "rotation_label": rot,
            "translation_label": t, "size_label": size}


def crop_batch(b: int, n: int, img: int, nclass: int, gen, device) -> dict:
    """Ready crops on ``device``: uniform RGB, a box cloud (``box_clouds``),
    random pixel indices and classes."""
    import torch
    return {"rgb": torch.rand(b, img, img, 3, generator=gen, device=device),
            "pts": box_clouds(b, n, gen, device)["pts"],
            "choose": torch.randint(0, img * img, (b, n), generator=gen,
                                    device=device, dtype=torch.int32),
            "category_label": torch.randint(0, nclass, (b,), generator=gen,
                                            device=device, dtype=torch.int32)}


def train_batch(b: int, n: int, img: int, nclass: int, gen, device) -> dict:
    """A prepared train batch (``{"inputs", "labels"}``) on ``device``:
    uniform RGB, random pixel indices and classes, and a box cloud with its
    pose labels and NOCS targets (``box_clouds``)."""
    import torch
    box = box_clouds(b, n, gen, device)
    inputs = {"rgb": torch.rand(b, img, img, 3, generator=gen, device=device),
              "pts": box["pts"],
              "choose": torch.randint(0, img * img, (b, n), generator=gen,
                                      device=device, dtype=torch.int32),
              "category_label": torch.randint(0, nclass, (b,), generator=gen,
                                              device=device,
                                              dtype=torch.int32),
              "qo": box["qo"],
              "sym_info": torch.zeros(b, 4, dtype=torch.int32, device=device)}
    return {"inputs": inputs,
            "labels": {k: box[k] for k in ("rotation_label",
                                           "translation_label", "size_label")}
            | {"qo": box["qo"]}}


def raw_train_batch(b: int, gen, device) -> dict:
    """A raw train batch as the device pipeline's dataset yields it, on
    ``device``: per sample a 480 x 640 frame of a slanted surface with one
    object in front of it (an 80-200 px box at 700-1100 mm), 10-30% of
    its pixels missing and the top 60 rows empty, the object's mask 5 px
    inside its box, uniform RGB, REAL275's intrinsics, a random proper
    rotation, the translation of the box's centre pixel at its depth, sizes
    ``U(0.05, 0.3)`` m and no symmetry."""
    import torch

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    h, w = FRAME_H, FRAME_W
    yy = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    hh = (80 + 120 * rand(b)).floor()
    ww = (80 + 120 * rand(b)).floor()
    y0 = (60 + (h - 60 - hh) * rand(b)).floor()
    x0 = ((w - ww) * rand(b)).floor()
    z0 = 700.0 + 400.0 * rand(b)

    def box(pad):
        return ((yy >= y0[:, None, None] + pad) & (yy < (y0 + hh - pad)[:, None, None])
                & (xx >= x0[:, None, None] + pad) & (xx < (x0 + ww - pad)[:, None, None]))

    depth = torch.where(box(0), z0[:, None, None] + 0.3 * xx,
                        1400.0 + 0.5 * xx + 0.8 * yy)
    holes = rand(b, h, w) < (0.1 + 0.2 * rand(b))[:, None, None]
    depth = torch.where(holes | (yy < 60), 0.0, depth)
    fx, fy, cx, cy = REAL_INTRINSICS
    cu, cv = x0 + ww / 2, y0 + hh / 2
    zc = (z0 + 0.3 * cu) / 1000.0
    t = torch.stack([(cu - cx) * zc / fx, (cv - cy) * zc / fy, zc], -1)
    q, r = torch.linalg.qr(torch.randn(b, 3, 3, generator=gen, device=device))
    rot = q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]
    rot[..., 2] *= torch.sign(torch.linalg.det(rot))[:, None]
    return {
        "depth_raw": depth,
        "rgb_raw": torch.randint(0, 256, (b, h, w, 3), generator=gen,
                                 device=device, dtype=torch.uint8),
        "mask_raw": box(5),
        "bbox": torch.stack([y0 + 5, x0 + 5, y0 + hh - 5, x0 + ww - 5],
                            -1).to(torch.int32),
        "intrinsics": torch.tensor(REAL_INTRINSICS, device=device).expand(
            b, 4).contiguous(),
        "category_label": torch.randint(0, 6, (b,), generator=gen,
                                        device=device),
        "rotation_label": rot, "translation_label": t,
        "size_label": 0.05 + 0.25 * rand(b, 3),
        "sym_info": torch.zeros(b, 4, dtype=torch.int32, device=device)}
