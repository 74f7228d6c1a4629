"""Pose visualization: project 3D boxes into the image and draw them.

The port's copy of ``istnet_tpu/eval/vis.py`` (the reference's
``utils/vis_utils.py:100-221``, itself from NOCS_CVPR2019): symmetric-class
rotation canonicalization, 3D box corner projection, layered box drawing
(ground darker / pillars mid / top full color), and the pred(red) /
gt(green) / nocs(blue) overlay writer. numpy and OpenCV on the host, pixel
for pixel JAX's.
"""

from __future__ import annotations

import math
import os

import cv2
import numpy as np

from istnet_tpu_torch.eval.nocs_map import get_3d_bbox, transform_coordinates_3d


def align_rotation(srt: np.ndarray) -> np.ndarray:
    """Canonicalize the y-axis rotation of a symmetric object's sRT
    (vis_utils.py:140-160)."""
    s = np.cbrt(np.linalg.det(srt[:3, :3]))
    r = srt[:3, :3] / s
    theta_x = r[0, 0] + r[2, 2]
    theta_y = r[0, 2] - r[2, 0]
    r_norm = math.sqrt(theta_x ** 2 + theta_y ** 2)
    s_map = np.array([[theta_x / r_norm, 0.0, -theta_y / r_norm],
                      [0.0, 1.0, 0.0],
                      [theta_y / r_norm, 0.0, theta_x / r_norm]])
    aligned = np.identity(4, dtype=np.float32)
    aligned[:3, :3] = s * (r @ s_map)
    aligned[:3, 3] = srt[:3, 3]
    return aligned


def calculate_2d_projections(coordinates_3d: np.ndarray, intrinsics: np.ndarray) -> np.ndarray:
    """(3, N) camera-space -> (N, 2) pixel coords (vis_utils.py:120-137)."""
    projected = intrinsics @ coordinates_3d
    projected = projected[:2] / projected[2]
    return projected.T.astype(np.int32)


def draw_bboxes(img: np.ndarray, img_pts: np.ndarray, color) -> np.ndarray:
    """Layered 3D box wireframe (vis_utils.py:163-177)."""
    img_pts = np.int32(img_pts).reshape(-1, 2)
    ground = tuple(int(c * 0.3) for c in color)
    for i, j in zip([4, 5, 6, 7], [5, 7, 4, 6]):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), ground, 2)
    pillar = tuple(int(c * 0.6) for c in color)
    for i, j in zip(range(4), range(4, 8)):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), pillar, 2)
    for i, j in zip([0, 1, 2, 3], [1, 3, 0, 2]):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), tuple(color), 2)
    return img


def draw_axes_box(img: np.ndarray, img_pts: np.ndarray, axes_pts: np.ndarray,
                  color) -> np.ndarray:
    """Layered 3D box wireframe PLUS xyz axes arrows (vis_utils.py:73-100).

    ``axes_pts`` are the 2D projections of [origin, x-end, y-end, z-end]
    (project ``transform_coordinates_3d(axes, srt)`` like the box corners).
    Axis colors follow the reference's BGR constants: x (index 1) red-channel
    (0,0,255), z (index 3) blue-channel (255,0,0), y (index 2) green, drawn
    last. Thickness 3 like the reference (draw_bboxes' thickness-2 variant
    mirrors its other renderer)."""
    img_pts = np.int32(img_pts).reshape(-1, 2)
    axes_pts = np.int32(axes_pts).reshape(-1, 2)
    ground = tuple(int(c * 0.3) for c in color)
    for i, j in zip([4, 5, 6, 7], [5, 7, 4, 6]):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), ground, 3)
    pillar = tuple(int(c * 0.6) for c in color)
    for i, j in zip(range(4), range(4, 8)):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), pillar, 3)
    for i, j in zip([0, 1, 2, 3], [1, 3, 0, 2]):
        img = cv2.line(img, tuple(img_pts[i]), tuple(img_pts[j]), tuple(color), 3)
    img = cv2.line(img, tuple(axes_pts[0]), tuple(axes_pts[1]), (0, 0, 255), 3)
    img = cv2.line(img, tuple(axes_pts[0]), tuple(axes_pts[3]), (255, 0, 0), 3)
    img = cv2.line(img, tuple(axes_pts[0]), tuple(axes_pts[2]), (0, 255, 0), 3)
    return img


def draw_text(draw_image: np.ndarray, bbox, text: str,
              draw_box: bool = False) -> np.ndarray:
    """Filled label box + text near a (y1, x1, y2, x2) detection bbox
    (vis_utils.py:103-139) with the reference's exact 10-px margins and
    TRIPLEX face. The reference hard-codes 635/475 clamps for its 640x480
    NOCS frames; we derive the same 5-px inset from the actual image shape
    (identical pixels at 640x480, correct placement on other sizes)."""
    font_face = cv2.FONT_HERSHEY_TRIPLEX
    font_scale = 1
    thickness = 1
    retval, _baseline = cv2.getTextSize(text, font_face, font_scale, thickness)

    bbox_margin = 10
    text_margin = 10
    clamp_x = draw_image.shape[1] - 5  # 635 on the reference's 640x480 frame
    clamp_y = draw_image.shape[0] - 5  # 475
    tl = (min(bbox[1] + bbox_margin, clamp_x - retval[0] - 2 * text_margin),
          min(bbox[2] + bbox_margin, clamp_y - retval[1] - 2 * text_margin))
    br = (tl[0] + retval[0] + 2 * text_margin,
          tl[1] + retval[1] + 2 * text_margin)
    # text_pos is the bottom-left corner of the text
    text_pos = (tl[0] + text_margin, br[1] - text_margin - 3)

    if draw_box:
        cv2.rectangle(draw_image, (bbox[1], bbox[0]), (bbox[3], bbox[2]),
                      (255, 0, 0), 2)
    cv2.rectangle(draw_image, tl, br, (255, 0, 0), -1)
    cv2.rectangle(draw_image, tl, br, (0, 0, 0), 1)
    cv2.putText(draw_image, text, text_pos, font_face, font_scale,
                (255, 255, 255), thickness)
    return draw_image


# NOCS category names, index = class id (reference data conventions)
CLASS_NAMES = ("BG", "bottle", "bowl", "camera", "can", "laptop", "mug")


def _draw_set(img, srts, sizes, class_ids, intrinsics, color,
              draw_axes: bool = False, draw_labels: bool = False):
    for i in range(len(srts)):
        srt = align_rotation(srts[i]) if class_ids[i] in (1, 2, 4) else srts[i]
        bbox = get_3d_bbox(sizes[i], 0)
        pts = calculate_2d_projections(transform_coordinates_3d(bbox, srt), intrinsics)
        if draw_axes:
            ax_len = float(np.max(sizes[i])) * 0.75
            axes = np.array([[0, 0, 0], [ax_len, 0, 0],
                             [0, ax_len, 0], [0, 0, ax_len]], np.float64).T
            ax_pts = calculate_2d_projections(
                transform_coordinates_3d(axes, srt), intrinsics)
            img = draw_axes_box(img, pts, ax_pts, color)
        else:
            img = draw_bboxes(img, pts, color)
        if draw_labels:
            cid = int(class_ids[i])
            name = CLASS_NAMES[cid] if 0 <= cid < len(CLASS_NAMES) else str(cid)
            u = pts[:, 0].clip(0, img.shape[1] - 1)
            v = pts[:, 1].clip(0, img.shape[0] - 1)
            img = draw_text(img, (int(v.min()), int(u.min()),
                                  int(v.max()), int(u.max())), name)
    return img


def draw_detections(img, out_dir, data_name, img_id, intrinsics,
                    pred_srt, pred_size, pred_class_ids,
                    gt_srt=None, gt_size=None, gt_class_ids=None,
                    nocs_srt=None, nocs_size=None, nocs_class_ids=None,
                    draw_gt: bool = True, draw_nocs: bool = False,
                    draw_axes: bool = False, draw_labels: bool = False):
    """Overlay pred (red) / gt (green) / nocs (blue) boxes; write a PNG
    (vis_utils.py:181-221). Returns the drawn image.

    ``draw_axes`` renders the reference's axes-arrow style (vis_utils.py:
    73-100) on the prediction boxes; ``draw_labels`` adds the class-name
    text box (vis_utils.py:103-139). Both are off by default to match the
    reference's own draw_detections, whose axes/text helpers are
    caller-level utilities with no internal callers."""
    intrinsics = np.asarray(intrinsics, np.float64)
    if draw_nocs and nocs_srt is not None:
        img = _draw_set(img, nocs_srt, nocs_size, nocs_class_ids, intrinsics, (255, 0, 0))
    if draw_gt and gt_srt is not None:
        img = _draw_set(img, gt_srt, gt_size, gt_class_ids, intrinsics, (0, 255, 0))
    img = _draw_set(img, pred_srt, pred_size, pred_class_ids, intrinsics, (0, 0, 255),
                    draw_axes=draw_axes, draw_labels=draw_labels)
    os.makedirs(out_dir, exist_ok=True)
    cv2.imwrite(os.path.join(out_dir, f"{data_name}_{img_id}_pred.png"), img)
    return img
