"""Depth decode / crop / completion utilities on the host (numpy + cv2).

The port's own copy of ``istnet_tpu/data/depth_utils.py``:

- ``load_depth``: 16-bit or RGB-encoded depth PNGs; the RGB encoding packs
  depth as G*256+B with 32001 as the invalid marker.
- ``get_bbox``: square crop snapped to 40-px multiples, max 440, clamped to
  the 480x640 frame.
- ``fill_in_multiscale`` / ``fill_missing``: the ip_basic-style multi-scale
  morphological depth completion with OpenCV calls: invert depths, dilate
  three distance bands with cross kernels, close, median-blur, hole-fill,
  6x masked dilation, median + bilateral blur, invert back. It is the golden
  reference of the device fill (``ops/depth_fill.py``) and the host path of
  ``TestDataset``.
- ``backproject``: depth map -> camera-space point map.
"""

from __future__ import annotations

import cv2
import numpy as np

FULL_KERNEL_5 = np.ones((5, 5), np.uint8)
FULL_KERNEL_9 = np.ones((9, 9), np.uint8)


def _cross_kernel(n: int) -> np.ndarray:
    k = np.zeros((n, n), np.uint8)
    k[n // 2, :] = 1
    k[:, n // 2] = 1
    return k


CROSS_KERNEL_3 = _cross_kernel(3)
CROSS_KERNEL_5 = _cross_kernel(5)
CROSS_KERNEL_7 = _cross_kernel(7)


def _decode_depth_png(depth_path: str) -> np.ndarray | None:
    depth = cv2.imread(depth_path, -1)
    if depth is None:
        return None
    if depth.ndim == 3:
        # RGB-encoded (BGR in cv2): depth16 = G*256 + B, 32001 -> invalid
        depth16 = depth[:, :, 1].astype(np.int32) * 256 + depth[:, :, 2]
        depth16 = np.where(depth16 == 32001, 0, depth16).astype(np.uint16)
        return depth16
    if depth.ndim == 2 and depth.dtype == np.uint16:
        return depth
    raise ValueError(f"unsupported depth format in {depth_path}")


def load_depth(img_path: str) -> np.ndarray | None:
    """``<img_path>_depth.png`` -> (480, 640) uint16 mm."""
    return _decode_depth_png(img_path + "_depth.png")


def get_bbox(bbox, img_height: int = 480, img_width: int = 640):
    """(y1, x1, y2, x2) -> square (rmin, rmax, cmin, cmax), 40-px-quantized."""
    y1, x1, y2, x2 = bbox
    window_size = (max(y2 - y1, x2 - x1) // 40 + 1) * 40
    window_size = min(window_size, 440)
    center = [(y1 + y2) // 2, (x1 + x2) // 2]
    rmin = center[0] - int(window_size / 2)
    rmax = center[0] + int(window_size / 2)
    cmin = center[1] - int(window_size / 2)
    cmax = center[1] + int(window_size / 2)
    if rmin < 0:
        rmax += -rmin
        rmin = 0
    if cmin < 0:
        cmax += -cmin
        cmin = 0
    if rmax > img_height:
        rmin -= rmax - img_height
        rmax = img_height
    if cmax > img_width:
        cmin -= cmax - img_width
        cmax = img_width
    return rmin, rmax, cmin, cmax


def fill_in_multiscale(depth_map: np.ndarray, max_depth: float = 3.0,
                       blur_type: str = "bilateral") -> np.ndarray:
    """Multi-scale morphological depth completion (``data_utils.py:199-510``)."""
    depths_in = np.float32(depth_map)

    near = (depths_in > 0.01) & (depths_in <= 1.0)
    med = (depths_in > 1.0) & (depths_in <= 2.0)
    far = depths_in > 2.0

    inv = depths_in.copy()
    valid = inv > 0.01
    inv[valid] = max_depth - inv[valid]

    dil_far = cv2.dilate(inv * far, CROSS_KERNEL_3)
    dil_med = cv2.dilate(inv * med, CROSS_KERNEL_5)
    dil_near = cv2.dilate(inv * near, CROSS_KERNEL_7)

    out = inv.copy()
    out[dil_far > 0.01] = dil_far[dil_far > 0.01]
    out[dil_med > 0.01] = dil_med[dil_med > 0.01]
    out[dil_near > 0.01] = dil_near[dil_near > 0.01]

    out = cv2.morphologyEx(out, cv2.MORPH_CLOSE, FULL_KERNEL_5)

    blurred = cv2.medianBlur(out, 5)
    valid = out > 0.01
    out[valid] = blurred[valid]

    # top mask: pixels above the first valid pixel per column stay empty
    top_mask = np.ones(out.shape, bool)
    top_rows = np.argmax(out > 0.01, axis=0)
    col_has = (out > 0.01).any(axis=0)
    rows = np.arange(out.shape[0])[:, None]
    top_mask = rows >= np.where(col_has, top_rows, 0)[None, :]

    empty = (~(out > 0.01)) & top_mask
    dilated = cv2.dilate(out, FULL_KERNEL_9)
    out[empty] = dilated[empty]

    # recompute top mask after the 9x9 fill (data_utils.py:292-307)
    top_rows = np.argmax(out > 0.01, axis=0)
    col_has = (out > 0.01).any(axis=0)
    top_mask = rows >= np.where(col_has, top_rows, 0)[None, :]

    for _ in range(6):
        empty = (out < 0.01) & top_mask
        dilated = cv2.dilate(out, FULL_KERNEL_5)
        out[empty] = dilated[empty]

    blurred = cv2.medianBlur(out, 5)
    valid = (out > 0.01) & top_mask
    out[valid] = blurred[valid]

    if blur_type == "gaussian":
        blurred = cv2.GaussianBlur(out, (5, 5), 0)
        valid = (out > 0.01) & top_mask
        out[valid] = blurred[valid]
    elif blur_type == "bilateral":
        blurred = cv2.bilateralFilter(out, 5, 0.5, 2.0)
        out[valid] = blurred[valid]

    valid = out > 0.01
    out[valid] = max_depth - out[valid]
    return out


def fill_missing(dpt: np.ndarray, cam_scale: float, scale_2_80m: float,
                 blur_type: str = "bilateral") -> np.ndarray:
    """Depth (sensor units) -> completed depth, same units: the multiscale
    fill at ``max_depth=3`` metres through the OpenCV calls."""
    dpt = dpt / cam_scale * scale_2_80m
    out = fill_in_multiscale(dpt.astype(np.float32), max_depth=3.0,
                             blur_type=blur_type)
    return out / scale_2_80m * cam_scale


def backproject_grid(intrinsics, height: int = 480, width: int = 640):
    """Precompute (xmap - cx)/fx and (ymap - cy)/fy factors for backprojection."""
    fx, fy, cx, cy = intrinsics
    xmap = np.tile(np.arange(width), (height, 1)).astype(np.float32)
    ymap = np.tile(np.arange(height)[:, None], (1, width)).astype(np.float32)
    return (xmap - cx) / fx, (ymap - cy) / fy


def backproject(depth: np.ndarray, intrinsics, norm_scale: float = 1000.0) -> np.ndarray:
    """(H, W) depth -> (H, W, 3) camera-space points in meters (dataset.py:204-208)."""
    xf, yf = backproject_grid(intrinsics, depth.shape[0], depth.shape[1])
    z = depth.astype(np.float32) / norm_scale
    return np.stack([xf * z, yf * z, z], axis=-1)
