"""Device-side preprocessing of raw frames on torch tensors: depth
completion, back-projection, square crop, in-mask point sampling and the
RGB resize, batched over instances; on the train side also the point
jitter, the NOCS target, ColorJitter and the ImageNet normalisation.

Counterpart of ``istnet_tpu/data/device_preprocess.py``. The functions run
on whatever device their tensors lie on. What the JAX module
does to please XLA on a TPU is not carried over: its blocked cumulative sum
and closed-form search are ``torch.cumsum`` and ``torch.searchsorted``, its
padded ``dynamic_slice`` crops are index arithmetic into the one frame, and
its two resize contractions are a two-tap gather with the same weights.

Random numbers: the sampler draws one uniform per stratum, the train side
a normal a point coordinate for the jitter and ColorJitter's draws
(``data/device_transforms.py``). The public functions take a
``torch.Generator`` on the tensors' device, or the draws themselves (the
uniforms ``v (K, sample_num)``, the normals ``noise (K, sample_num, 3)``),
which is how a test or a card-against-CPU check feeds two sides the same
numbers. Nothing here waits for the card: no value is read back, no
tensor is built from host data inside a call.

Indices that JAX's gathers clamp silently are clamped here: an instance
with no valid pixel (a padding row of a bucket) has its flat indices capped
at the crop's last cell and its ``choose`` at the resized crop's last
pixel, so that nothing downstream indexes out of range on the card.
"""

from __future__ import annotations

import functools

import torch

from istnet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from istnet_tpu_torch.ops import dispatch

MAX_CROP = 440  # get_bbox's largest square window
SHIFT_RANGE = 0.005  # the jitter's clamp, fixed as the reference fixes it


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true float32 division on every device. With a Python
    scalar PyTorch's CUDA kernel multiplies by the rounded reciprocal, one
    ulp off the CPU's and JAX's quotient; where a ``floor`` follows, that
    ulp picks another pixel."""
    return x / torch.full_like(x, c)


def fill_missing(depth_mm: torch.Tensor, cam_scale: float = 1000.0,
                 scale_2_80m: float = 1.0) -> torch.Tensor:
    """``depth_utils.fill_missing`` on the device, batched: (B, H, W) depth
    in sensor units -> completed, same units. On a CUDA tensor the chain is
    kernel 11 (``ops/depth_fill.py``), on a CPU tensor its plain version."""
    x = _div(depth_mm.float(), cam_scale) * scale_2_80m
    return _div(dispatch.fill_in_multiscale(x, 3.0), scale_2_80m) * cam_scale


def backproject_batch(depth: torch.Tensor, intrinsics: torch.Tensor,
                      norm_scale: float = 1000.0) -> torch.Tensor:
    """(B, H, W) depth (mm) + intrinsics [fx, fy, cx, cy], shared ``(4,)``
    or per-sample ``(B, 4)`` -> (B, H, W, 3) metres."""
    _, h, w = depth.shape
    intrinsics = intrinsics.to(depth.device, torch.float32)
    if intrinsics.dim() == 2:
        fx, fy, cx, cy = (intrinsics[:, i][:, None, None] for i in range(4))
    else:
        fx, fy, cx, cy = intrinsics
    z = _div(depth.float(), norm_scale)
    xs = torch.arange(w, dtype=torch.float32, device=depth.device)[None, None, :]
    ys = torch.arange(h, dtype=torch.float32, device=depth.device)[None, :, None]
    return torch.stack([(xs - cx) * z / fx, (ys - cy) * z / fy, z], dim=-1)


def square_crop_bounds(bboxes: torch.Tensor, img_h: int = 480,
                       img_w: int = 640) -> torch.Tensor:
    """Vectorised ``depth_utils.get_bbox``: (K, 4) [y1, x1, y2, x2] ->
    (K, 4) [rmin, rmax, cmin, cmax], 40-px-quantised square windows."""
    y1, x1, y2, x2 = (bboxes[:, i].long() for i in range(4))
    win = (torch.maximum(y2 - y1, x2 - x1) // 40 + 1) * 40
    win = win.clamp(max=MAX_CROP)
    rmin = (y1 + y2) // 2 - win // 2
    cmin = (x1 + x2) // 2 - win // 2
    rmax = rmin + win
    cmax = cmin + win
    # clamp-and-shift, the reference's four fix-ups in their order
    shift = (-rmin).clamp(min=0)
    rmin, rmax = rmin + shift, rmax + shift
    shift = (-cmin).clamp(min=0)
    cmin, cmax = cmin + shift, cmax + shift
    shift = (rmax - img_h).clamp(min=0)
    rmin, rmax = rmin - shift, rmax - shift
    shift = (cmax - img_w).clamp(min=0)
    cmin, cmax = cmin - shift, cmax - shift
    return torch.stack([rmin, rmax, cmin, cmax], dim=1)


def _resize_half_pixel(frames: torch.Tensor, frame_of: torch.Tensor,
                       rmin: torch.Tensor, cmin: torch.Tensor,
                       crop_w: torch.Tensor, out_size: int) -> torch.Tensor:
    """Bilinear resize (cv2 ``INTER_LINEAR``: half-pixel centres, border
    clamp) of the ``(crop_w, crop_w)`` window at ``(rmin, cmin)`` of frame
    ``frame_of`` to ``(out_size, out_size)``, per instance: frames
    (F, H, W, C) -> (K, out_size, out_size, C) float32.

    Each output pixel blends two rows, then two columns, with the weights
    ``max(0, 1 - |pos - j|)`` of the JAX module's two contractions."""
    cw = crop_w.float()[:, None]
    pos = (torch.arange(out_size, dtype=torch.float32, device=frames.device)
           + 0.5) * _div(cw, out_size) - 0.5
    pos = torch.minimum(pos.clamp(min=0.0), cw - 1.0)          # (K, out)
    i0 = pos.floor()
    w0 = 1.0 - (pos - i0)
    w1 = (1.0 - ((i0 + 1.0) - pos)).clamp(min=0.0)
    i0 = i0.long()
    i1 = torch.minimum(i0 + 1, crop_w.long()[:, None] - 1)
    h, w = frames.shape[1:3]
    f = frame_of[:, None, None]

    def rows_cols(i):
        return ((rmin[:, None] + i).clamp(max=h - 1),
                (cmin[:, None] + i).clamp(max=w - 1))

    (r0, c0), (r1, c1) = rows_cols(i0), rows_cols(i1)

    def tap(r, c):
        return frames[f, r[:, :, None], c[:, None, :]].float()

    wr0, wr1 = w0[:, :, None, None], w1[:, :, None, None]
    left = wr0 * tap(r0, c0) + wr1 * tap(r1, c0)
    right = wr0 * tap(r0, c1) + wr1 * tap(r1, c1)
    return w0[:, None, :, None] * left + w1[:, None, :, None] * right


def sample_valid_cells(ok: torch.Tensor, v: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stratified inverse-CDF sample of the true cells of ``ok (K, n)``
    with the uniforms ``v (K, S)``: stratum ``s`` of the valid cells' CDF
    gives one index, so the sample is duplicate-free when a row has at least
    ``S`` valid cells and wraps around with repeats when it has fewer (all
    of them are drawn when there are at most ``S / 2``). Returns
    ``(flat_idx (K, S) int64, count (K,) int64)``; a row with no valid cell
    gets ``n - 1`` throughout."""
    n = ok.shape[1]
    s = v.shape[1]
    cdf = torch.cumsum(ok, dim=1, dtype=torch.int32)
    count = cdf[:, -1]
    slot = torch.arange(s, dtype=torch.float32, device=v.device)
    u = _div(slot + v, s) * count.float()[:, None]
    targets = u.floor().to(torch.int32) + 1
    targets = torch.minimum(targets, count.clamp(min=1)[:, None])
    flat_idx = torch.searchsorted(cdf, targets, right=False)
    return flat_idx.clamp(max=n - 1), count.long()


@functools.lru_cache(maxsize=None)
def _imagenet(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """ImageNet's mean and std on ``device``, copied there once."""
    return (torch.from_numpy(IMAGENET_MEAN).to(device),
            torch.from_numpy(IMAGENET_STD).to(device))


def normalize_rgb(rgb: torch.Tensor) -> torch.Tensor:
    """0..255 float rgb -> ImageNet-normalised."""
    mean, std = _imagenet(rgb.device)
    return (_div(rgb, 255.0) - mean) / std


def _preprocess(frames_rgb, frames_depth, frame_of, masks, bboxes, intrinsics,
                generator, v, img_size, sample_num, norm_scale, normalize):
    device = frames_depth.device
    k_inst, h, w = masks.shape
    bounds = square_crop_bounds(bboxes.to(device), h, w)
    rmin, cmin = bounds[:, 0], bounds[:, 2]
    crop_w = bounds[:, 1] - bounds[:, 0]

    if v is None:
        v = torch.rand(k_inst, sample_num, generator=generator, device=device)
    v = v.to(device, torch.float32)

    # the (MAX_CROP, MAX_CROP) window of each instance's validity map,
    # top-left aligned, gathered from the frame by index arithmetic
    valid = masks.to(device, torch.bool) & (frames_depth > 0)[frame_of]
    span = torch.arange(MAX_CROP, device=device)
    rows = (rmin[:, None] + span).clamp(max=h - 1)               # (K, 440)
    cols = (cmin[:, None] + span).clamp(max=w - 1)
    inside = span[None, :] < crop_w[:, None]
    k_idx = torch.arange(k_inst, device=device)[:, None, None]
    ok = (valid[k_idx, rows[:, :, None], cols[:, None, :]]
          & inside[:, :, None] & inside[:, None, :])
    flat_idx, count = sample_valid_cells(ok.reshape(k_inst, -1), v)

    row_idx = flat_idx // MAX_CROP
    col_idx = flat_idx % MAX_CROP
    pts_map = backproject_batch(frames_depth, intrinsics, norm_scale)
    pts = pts_map[frame_of[:, None],
                  (rmin[:, None] + row_idx).clamp(max=h - 1),
                  (cmin[:, None] + col_idx).clamp(max=w - 1)]
    # choose for the resized crop
    cw = crop_w.float()[:, None]
    ratio = torch.full_like(cw, img_size) / cw
    choose = ((row_idx * ratio).floor() * img_size
              + (col_idx * ratio).floor()).to(torch.int32)
    choose = choose.clamp(max=img_size * img_size - 1)

    rgb = _resize_half_pixel(frames_rgb, frame_of, rmin, cmin, crop_w,
                             img_size)
    if normalize:
        rgb = normalize_rgb(rgb)
    return {"rgb": rgb, "pts": pts, "choose": choose,
            "n_valid": count.to(torch.int32), "flat_idx": flat_idx}


def preprocess_instances(rgb: torch.Tensor, depth_mm: torch.Tensor,
                         masks: torch.Tensor, bboxes: torch.Tensor,
                         intrinsics: torch.Tensor,
                         generator: torch.Generator | None = None,
                         img_size: int = 192, sample_num: int = 1024,
                         norm_scale: float = 1000.0, normalize: bool = True,
                         v: torch.Tensor | None = None) -> dict:
    """Per-instance test preprocessing, one image per INSTANCE: square
    crop, in-mask point sampling, back-projection, RGB resize and ImageNet
    normalisation.

    rgb (B, H, W, 3) uint8, depth_mm (B, H, W) completed depth in mm, masks
    (B, H, W) bool, bboxes (B, 4) [y1, x1, y2, x2], intrinsics ``(4,)`` or
    ``(B, 4)``. Returns rgb (B, img, img, 3), pts (B, N, 3) metres, choose
    (B, N) int32 into the resized crop, n_valid (B,) in-mask pixel counts,
    flat_idx (B, N) cells of the 440-wide crop window."""
    frame_of = torch.arange(masks.shape[0], device=depth_mm.device)
    return _preprocess(rgb, depth_mm, frame_of, masks, bboxes, intrinsics,
                       generator, v, img_size, sample_num, norm_scale,
                       normalize)


def preprocess_shared_image(rgb: torch.Tensor, depth_mm: torch.Tensor,
                            masks: torch.Tensor, bboxes: torch.Tensor,
                            intrinsics: torch.Tensor,
                            generator: torch.Generator | None = None,
                            img_size: int = 192, sample_num: int = 1024,
                            norm_scale: float = 1000.0,
                            v: torch.Tensor | None = None) -> dict:
    """``preprocess_instances`` when all K instances come from ONE image
    (the test-time case): rgb (H, W, 3) uint8, depth_mm (H, W), masks
    (K, H, W) bool, bboxes (K, 4). The frame is back-projected once."""
    frame_of = torch.zeros(masks.shape[0], dtype=torch.long,
                           device=depth_mm.device)
    return _preprocess(rgb[None], depth_mm[None], frame_of, masks, bboxes,
                       intrinsics, generator, v, img_size, sample_num,
                       norm_scale, True)


def preprocess_train_instances(rgb: torch.Tensor, depth_mm: torch.Tensor,
                               masks: torch.Tensor, bboxes: torch.Tensor,
                               intrinsics: torch.Tensor,
                               rotation: torch.Tensor,
                               translation: torch.Tensor, size: torch.Tensor,
                               generator: torch.Generator | None = None,
                               img_size: int = 192, sample_num: int = 1024,
                               normalize: bool = True,
                               v: torch.Tensor | None = None,
                               noise: torch.Tensor | None = None) -> dict:
    """The train side of ``preprocess_instances``: its outputs with the
    points jittered by ``clamp(0.001 * noise, +-SHIFT_RANGE)`` and the NOCS
    target ``qo = (pts - t) / (||s|| + 1e-8) @ R`` (R made canonical for
    the symmetric classes on the host). ``noise (B, N, 3)`` standard
    normals, drawn from ``generator`` when not given; with ``normalize``
    False the rgb stays 0..255 for ColorJitter."""
    out = preprocess_instances(rgb, depth_mm, masks, bboxes, intrinsics,
                               generator, img_size, sample_num,
                               normalize=normalize, v=v)
    if noise is None:
        noise = torch.randn(out["pts"].shape, generator=generator,
                            device=out["pts"].device)
    pts = out["pts"] + (0.001 * noise).clamp(-SHIFT_RANGE, SHIFT_RANGE)
    scale = torch.linalg.norm(size, dim=-1)[:, None, None] + 1e-8
    qo = (pts - translation[:, None, :]) / scale
    out["pts"] = pts
    out["qo"] = qo @ rotation.to(qo.dtype)
    return out


def draw_preprocess(b: int, generator: torch.Generator,
                    sample_num: int = 1024, device=None) -> dict:
    """The sampler's uniforms ``v (b, sample_num)`` and the jitter's
    normals ``noise (b, sample_num, 3)`` from ``generator`` (on ``device``,
    the generator's by default)."""
    device = torch.device(device if device is not None else generator.device)
    return {"v": torch.rand(b, sample_num, generator=generator, device=device),
            "noise": torch.randn(b, sample_num, 3, generator=generator,
                                 device=device)}


def make_train_preprocess(img_size: int = 192, sample_num: int = 1024,
                          use_fill_miss: bool = True):
    """The whole train input pipeline on the raw batch's device:
    ``preprocess(raw, generator_or_draws) -> {"inputs", "labels"}`` with the
    JAX package's keys. ``raw`` is a collated batch of
    ``TrainingDataset(device_preprocess=True)``: ``depth_raw`` (B, H, W)
    float32 mm, ``rgb_raw`` (B, H, W, 3) uint8, ``mask_raw`` (B, H, W)
    bool, ``bbox`` (B, 4), ``intrinsics`` (B, 4), the pose labels,
    ``category_label`` and ``sym_info``. Steps: depth completion (kernel 11
    on a card), crop, sampling, back-projection, jitter, ``qo``, resize,
    ColorJitter, normalisation. The second argument is a
    ``torch.Generator`` or the draws: ``{"v", "noise"}`` of
    ``draw_preprocess`` and ``"color"``, those of
    ``device_transforms.draw_color_jitter``."""
    from istnet_tpu_torch.data import device_transforms

    def preprocess(raw: dict, generator_or_draws) -> dict:
        depth = raw["depth_raw"].float()
        b = depth.shape[0]
        if isinstance(generator_or_draws, dict):
            draws = generator_or_draws
        else:
            draws = {**draw_preprocess(b, generator_or_draws, sample_num,
                                       depth.device),
                     "color": device_transforms.draw_color_jitter(
                         b, generator_or_draws, device=depth.device)}
        if use_fill_miss:
            depth = fill_missing(depth)
        out = preprocess_train_instances(
            raw["rgb_raw"], depth, raw["mask_raw"], raw["bbox"],
            raw["intrinsics"], raw["rotation_label"],
            raw["translation_label"], raw["size_label"], img_size=img_size,
            sample_num=sample_num, normalize=False,
            v=draws["v"], noise=draws["noise"])
        rgb = device_transforms.color_jitter_batch(out["rgb"], draws["color"])
        inputs = {"rgb": normalize_rgb(rgb), "pts": out["pts"],
                  "choose": out["choose"],
                  "category_label": raw["category_label"].to(torch.int32),
                  "qo": out["qo"], "sym_info": raw["sym_info"]}
        labels = {"rotation_label": raw["rotation_label"],
                  "translation_label": raw["translation_label"],
                  "size_label": raw["size_label"], "qo": out["qo"]}
        return {"inputs": inputs, "labels": labels}

    return preprocess
