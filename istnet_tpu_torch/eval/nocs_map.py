"""NOCS mAP evaluation (3D IoU + degree/cm pose AP); the port's own copy of
``istnet_tpu/eval/nocs_map.py``, numpy only.

Rebuild of the reference ``utils/evaluation_utils.py`` (itself derived from
NOCS_CVPR2019), with the same algorithmic contract but vectorized:

- 3D IoU with the 20-step y-axis symmetry sweep for bottle/bowl/can and
  handle-invisible mugs (``evaluation_utils.py:116-172``) — batched over
  pred x gt x rotations in one einsum instead of nested python loops.
- Greedy score-ordered matching with the reference's exact tie rules
  (strict ``iou > thres`` at ``evaluation_utils.py:580``; descending-overlap
  scan with break-below-threshold) — vectorized over the threshold axis.
- Degree/cm errors with symmetry rules (y-axis classes; mug handle rule;
  det-normalized R — ``evaluation_utils.py:588-661``), matched greedily by
  ascending theta+shift (``evaluation_utils.py:690-732``), vectorized over the
  (degree, shift) threshold grid.
- VOC-style AP from matches+scores (``evaluation_utils.py:87-113``),
  vectorized over all threshold axes at once.
- ``use_matches_for_pose``: pose AP only over instances matched at IoU 0.1
  (``evaluation_utils.py:836-858``).

One deliberate fix: the reference's y-axis angle omits the arccos clip
(``evaluation_utils.py:637-646``), so fp rounding can produce NaN angles that
then pass every threshold (NaN > t is False). We clip to [-1, 1].

All of this is CPU numpy — it consumes per-image result dicts, not tensors.
A slow loop-for-loop golden path lives in tests for cross-checking.
"""

from __future__ import annotations

import glob
import math
import os
import pickle
from typing import Sequence

import numpy as np

SYNSET_NAMES = ["BG", "bottle", "bowl", "camera", "can", "laptop", "mug"]
_Y_SYM_CLASSES = {"bottle", "bowl", "can"}


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def get_3d_bbox(scale, shift=0.0) -> np.ndarray:
    """(3,) scale -> (3, 8) corner coordinates (evaluation_utils.py:38-66)."""
    s = np.asarray(scale, np.float64)
    corners = np.array([[sx, sy, sz] for sx in (0.5, -0.5)
                        for sy in (0.5, -0.5) for sz in (0.5, -0.5)])
    return (corners * s + shift).T  # (3, 8)


def transform_coordinates_3d(coords: np.ndarray, rt: np.ndarray) -> np.ndarray:
    """(3, N), (4, 4) -> (3, N) homogeneous transform (evaluation_utils.py:69-84)."""
    hom = np.vstack([coords, np.ones((1, coords.shape[1]))])
    out = rt @ hom
    return out[:3] / out[3]


def _y_rotation_mats(n: int = 20) -> np.ndarray:
    thetas = 2 * math.pi * np.arange(n) / n
    mats = np.tile(np.eye(4), (n, 1, 1))
    c, s = np.cos(thetas), np.sin(thetas)
    mats[:, 0, 0] = c
    mats[:, 0, 2] = s
    mats[:, 2, 0] = -s
    mats[:, 2, 2] = c
    return mats


_YROT20 = _y_rotation_mats(20)


def _aabb_corners(rts: np.ndarray, scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Axis-aligned bounds of transformed unit boxes.

    rts: (..., 4, 4), scales: (..., 3) -> (mins (..., 3), maxs (..., 3)).
    """
    corners = np.array([[sx, sy, sz] for sx in (0.5, -0.5)
                        for sy in (0.5, -0.5) for sz in (0.5, -0.5)])  # (8, 3)
    pts = np.einsum("...ij,...kj->...ki", rts[..., :3, :3],
                    corners * scales[..., None, :])
    pts = pts + rts[..., None, :3, 3]
    w = rts[..., 3, 3]
    pts = pts / w[..., None, None]
    return pts.min(axis=-2), pts.max(axis=-2)


def compute_3d_iou_matrix(pred_rts: np.ndarray, pred_scales: np.ndarray,
                          gt_rts: np.ndarray, gt_scales: np.ndarray,
                          symmetric: np.ndarray) -> np.ndarray:
    """Pairwise 3D IoU (P, G), with the y-rotation sweep applied to symmetric
    gt instances (evaluation_utils.py:116-172: symmetry is decided per-gt via
    class + handle visibility; the sweep rotates the *pred* box).
    """
    p, g = len(pred_rts), len(gt_rts)
    if p == 0 or g == 0:
        return np.zeros((p, g), np.float32)

    gt_min, gt_max = _aabb_corners(gt_rts, gt_scales)  # (G, 3)

    def pairwise(pmin, pmax):
        omin = np.maximum(pmin[:, None], gt_min[None])  # (P, G, 3)
        omax = np.minimum(pmax[:, None], gt_max[None])
        edge = omax - omin
        inter = np.where((edge > 0).all(-1), np.prod(edge, -1), 0.0)
        vol_p = np.prod(pmax - pmin, -1)
        vol_g = np.prod(gt_max - gt_min, -1)
        union = vol_p[:, None] + vol_g[None] - inter
        return inter / union

    pmin, pmax = _aabb_corners(pred_rts, pred_scales)
    ious = pairwise(pmin, pmax)  # asymmetric result

    if symmetric.any():
        rot_rts = np.einsum("pij,rjk->prik", pred_rts, _YROT20)  # (P, 20, 4, 4)
        rmin, rmax = _aabb_corners(rot_rts, np.broadcast_to(
            pred_scales[:, None, :], (p, 20, 3)))  # (P, 20, 3)
        omin = np.maximum(rmin[:, :, None], gt_min[None, None])  # (P, 20, G, 3)
        omax = np.minimum(rmax[:, :, None], gt_max[None, None])
        edge = omax - omin
        inter = np.where((edge > 0).all(-1), np.prod(edge, -1), 0.0)
        vol_p = np.prod(rmax - rmin, -1)  # (P, 20)
        vol_g = np.prod(gt_max - gt_min, -1)  # (G,)
        union = vol_p[:, :, None] + vol_g[None, None] - inter
        sym_iou = (inter / union).max(axis=1)  # (P, G)
        ious = np.where(symmetric[None, :], sym_iou, ious)
    return ious.astype(np.float32)


def compute_rt_errors(pred_rts: np.ndarray, gt_rts: np.ndarray,
                      y_axis_sym: np.ndarray) -> np.ndarray:
    """Pairwise (P, G, 2) [theta degrees, shift cm] (evaluation_utils.py:588-661).

    R is de-scaled by cbrt(det); y-axis-symmetric gts compare rotated y axes,
    others use the trace formula (clipped).
    """
    p, g = len(pred_rts), len(gt_rts)
    if p == 0 or g == 0:
        return np.zeros((p, g, 2), np.float32)

    def descale(rts):
        r = rts[:, :3, :3]
        det = np.linalg.det(r)
        return r / np.cbrt(det)[:, None, None]

    r1 = descale(pred_rts)  # (P, 3, 3)
    r2 = descale(gt_rts)  # (G, 3, 3)
    t1 = pred_rts[:, :3, 3]
    t2 = gt_rts[:, :3, 3]

    # y-axis comparison
    y1 = r1[:, :, 1]  # R @ [0,1,0]
    y2 = r2[:, :, 1]
    cos_y = np.einsum("pi,gi->pg", y1, y2) / (
        np.linalg.norm(y1, axis=-1)[:, None] * np.linalg.norm(y2, axis=-1)[None])
    theta_y = np.degrees(np.arccos(np.clip(cos_y, -1.0, 1.0)))

    # full rotation comparison
    tr = np.einsum("pij,gij->pg", r1, r2)  # trace(R1 @ R2^T)
    theta_full = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))

    theta = np.where(y_axis_sym[None, :], theta_y, theta_full)
    shift = np.linalg.norm(t1[:, None] - t2[None], axis=-1) * 100.0
    return np.stack([theta, shift], axis=-1).astype(np.float32)


# ---------------------------------------------------------------------------
# greedy matching (reference order semantics, vectorized over thresholds)
# ---------------------------------------------------------------------------

def greedy_match_iou(overlaps: np.ndarray, thres_list: np.ndarray):
    """Score-ordered greedy match per IoU threshold (evaluation_utils.py:550-585).

    ``overlaps`` rows must already be in descending-score pred order.
    Returns (gt_matches (T, G), pred_matches (T, P)) of matched indices or -1.
    """
    p, g = overlaps.shape
    t = len(thres_list)
    gt_m = -np.ones((t, g))
    pred_m = -np.ones((t, p))
    for i in range(p):
        order = np.argsort(overlaps[i])[::-1]
        for j in order:
            iou = overlaps[i, j]
            if iou < 0:
                break  # score_threshold trim (evaluation_utils.py:563-567)
            # strict > (evaluation_utils.py:580); first eligible j in
            # descending-iou order wins per threshold
            ok = (gt_m[:, j] == -1) & (pred_m[:, i] == -1) & (iou > thres_list)
            gt_m[ok, j] = i
            pred_m[ok, i] = j
    return gt_m, pred_m


def greedy_match_pose(errors: np.ndarray, degree_list: np.ndarray,
                      shift_list: np.ndarray):
    """Greedy match per (degree, shift) threshold pair
    (evaluation_utils.py:690-732): preds in given order, gts scanned by
    ascending theta+shift; match requires theta <= d AND shift <= s.
    """
    p, g = errors.shape[:2]
    d, s = len(degree_list), len(shift_list)
    gt_m = -np.ones((d, s, g))
    pred_m = -np.ones((d, s, p))
    for i in range(p):
        order = np.argsort(errors[i, :, 0] + errors[i, :, 1])
        for j in order:
            theta, shift = errors[i, j]
            ok = ((gt_m[:, :, j] == -1) & (pred_m[:, :, i] == -1)
                  & (theta <= degree_list[:, None]) & (shift <= shift_list[None, :]))
            gt_m[ok, j] = i
            pred_m[ok, i] = j
    return gt_m, pred_m


def ap_from_matches(pred_matches: np.ndarray, pred_scores: np.ndarray,
                    n_gt: int) -> np.ndarray:
    """VOC AP (evaluation_utils.py:87-113), vectorized over leading axes.

    pred_matches: (..., P); pred_scores: (P,) shared across leading axes.
    """
    lead = pred_matches.shape[:-1]
    p = pred_matches.shape[-1]
    if p == 0 or n_gt == 0:
        return np.zeros(lead)
    order = np.argsort(pred_scores)[::-1]
    matched = pred_matches[..., order] > -1  # (..., P)
    cum = np.cumsum(matched, axis=-1).astype(np.float64)
    precisions = cum / (np.arange(p) + 1)
    recalls = cum / n_gt

    pad_shape = lead + (1,)
    precisions = np.concatenate(
        [np.zeros(pad_shape), precisions, np.zeros(pad_shape)], axis=-1)
    recalls = np.concatenate(
        [np.zeros(pad_shape), recalls, np.ones(pad_shape)], axis=-1)
    # monotone precision envelope
    precisions = np.flip(np.maximum.accumulate(np.flip(precisions, -1), -1), -1)
    changed = recalls[..., 1:] != recalls[..., :-1]
    return np.sum((recalls[..., 1:] - recalls[..., :-1])
                  * precisions[..., 1:] * changed, axis=-1)


def greedy_match_combination(overlaps: np.ndarray, errors: np.ndarray,
                             degree_list: np.ndarray, shift_list: np.ndarray,
                             iou_list: np.ndarray):
    """Joint-threshold greedy match (evaluation_utils.py:252-336): preds in
    score order scan gts by descending IoU; the scan BREAKS at the first gt
    failing (iou >= t AND r_err <= d AND t_err <= s) — even if a later gt
    would pass. Vectorized over the (D, S, I) threshold grid.

    errors[..., 1] is the gt-scale-relative translation error
    (evaluation_utils.py:246: ``shift = norm(T1-T2)/scale``).
    """
    p, g = overlaps.shape
    d, s, t = len(degree_list), len(shift_list), len(iou_list)
    gt_m = -np.ones((d, s, t, g))
    pred_m = -np.ones((d, s, t, p))
    for i in range(p):
        order = np.argsort(overlaps[i])[::-1]
        low = np.where(overlaps[i, order] < 0)[0]
        if low.size:
            order = order[:low[0]]
        reachable = np.ones((d, s, t), bool)
        for j in order:
            iou = overlaps[i, j]
            r_err, t_err = errors[i, j]
            passes = ((iou >= iou_list[None, None, :])
                      & (r_err <= degree_list[:, None, None])
                      & (t_err <= shift_list[None, :, None]))
            elig = (reachable & passes & (gt_m[:, :, :, j] == -1)
                    & (pred_m[:, :, :, i] == -1))
            gt_m[elig, j] = i
            pred_m[elig, i] = j
            reachable &= passes
    return gt_m, pred_m


def compute_combination_map(final_results: Sequence[dict],
                            synset_names: Sequence[str] = SYNSET_NAMES,
                            degree_thresholds: Sequence[float] = (5, 10, 15),
                            shift_thresholds: Sequence[float] = (0.1, 0.2),
                            iou_3d_thresholds: Sequence[float] = (0.1,),
                            logger=None):
    """Joint-threshold mAP (evaluation_utils.py:339-453): a prediction counts
    only if IoU, rotation and (relative) translation thresholds hold
    simultaneously. Returns aps (C+1, D, S, I)."""
    num_classes = len(synset_names)
    degree_list = np.asarray(list(degree_thresholds) + [360], np.float64)
    shift_list = np.asarray(list(shift_thresholds) + [100], np.float64)
    iou_list = np.asarray(list(iou_3d_thresholds), np.float64)

    pm = [[] for _ in range(num_classes)]
    sc = [[] for _ in range(num_classes)]
    ngt = [0] * num_classes

    for result in final_results:
        gt_class_ids = np.asarray(result["gt_class_ids"], np.int32).reshape(-1)
        gt_rts = np.asarray(result["gt_RTs"], np.float64).reshape(-1, 4, 4)
        gt_scales = np.asarray(result["gt_scales"], np.float64).reshape(-1, 3)
        gt_handle = np.asarray(result.get(
            "gt_handle_visibility", np.ones_like(gt_class_ids))).reshape(-1)
        pred_class_ids = np.asarray(result["pred_class_ids"], np.int32).reshape(-1)
        pred_rts = np.asarray(result["pred_RTs"], np.float64).reshape(-1, 4, 4)
        pred_scales = np.asarray(result["pred_scales"], np.float64).reshape(-1, 3)
        pred_scores = np.asarray(result["pred_scores"], np.float64).reshape(-1)
        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue
        for cls_id in range(1, num_classes):
            gsel = gt_class_ids == cls_id
            psel = pred_class_ids == cls_id
            c_gt_rts, c_gt_scales = gt_rts[gsel], gt_scales[gsel]
            c_pred_rts, c_pred_scales = pred_rts[psel], pred_scales[psel]
            c_scores = pred_scores[psel]
            name = synset_names[cls_id]
            c_handle = gt_handle[gsel] if name == "mug" else np.ones(int(gsel.sum()))
            order = np.argsort(c_scores)[::-1]
            c_pred_rts, c_pred_scales = c_pred_rts[order], c_pred_scales[order]
            c_scores = c_scores[order]
            sym = np.asarray([(name in _Y_SYM_CLASSES)
                              or (name == "mug" and h == 0) for h in c_handle], bool)
            overlaps = compute_3d_iou_matrix(
                c_pred_rts, c_pred_scales, c_gt_rts, c_gt_scales, sym)
            errors = compute_rt_errors(c_pred_rts, c_gt_rts, sym)
            if errors.size:  # relative shift: /(gt scale) instead of *100 cm
                gscale = np.cbrt(np.linalg.det(c_gt_rts[:, :3, :3]))
                errors = errors.copy()
                errors[:, :, 1] = errors[:, :, 1] / 100.0 / gscale[None, :]
            _, pred_match = greedy_match_combination(
                overlaps, errors, degree_list, shift_list, iou_list)
            pm[cls_id].append(pred_match)
            sc[cls_id].append(c_scores)
            ngt[cls_id] += len(c_gt_rts)

    aps = np.zeros((num_classes + 1, len(degree_list), len(shift_list), len(iou_list)))
    for cls_id in range(1, num_classes):
        m = (np.concatenate(pm[cls_id], axis=-1) if pm[cls_id]
             else np.zeros((len(degree_list), len(shift_list), len(iou_list), 0)))
        s_ = np.concatenate(sc[cls_id]) if sc[cls_id] else np.zeros(0)
        aps[cls_id] = ap_from_matches(m, s_, ngt[cls_id])
    aps[-1] = aps[1:-1].mean(axis=0)
    return aps


def compute_3d_matches_for_each_gt(gt_class_ids, gt_rts, gt_scales,
                                   gt_handle_visibility,
                                   pred_class_ids, pred_rts, pred_scales,
                                   pred_scores,
                                   synset_names=SYNSET_NAMES):
    """Visualization matcher (evaluation_utils.py:456-505): for each GT, the
    best-IoU unmatched same-class prediction (no threshold). Returns
    (gt_matches (G,) pred indices in score-sorted order or -1,
     score_order (P,) the sorting applied to predictions)."""
    gt_class_ids = np.asarray(gt_class_ids, np.int32)
    pred_class_ids = np.asarray(pred_class_ids, np.int32)
    order = np.argsort(np.asarray(pred_scores))[::-1] if len(pred_class_ids) else np.zeros(0, int)
    pred_rts = np.asarray(pred_rts, np.float64)[order]
    pred_scales = np.asarray(pred_scales, np.float64)[order]
    pred_class_ids = pred_class_ids[order]

    g = len(gt_class_ids)
    sym = np.asarray([
        (synset_names[c] in _Y_SYM_CLASSES)
        or (synset_names[c] == "mug" and gt_handle_visibility[i] == 0)
        for i, c in enumerate(gt_class_ids)], bool)
    overlaps = compute_3d_iou_matrix(
        pred_rts, pred_scales, np.asarray(gt_rts, np.float64),
        np.asarray(gt_scales, np.float64), sym).T  # (G, P)
    # per-gt class mask: the reference compares classes inside the scan
    cls_ok = pred_class_ids[None, :] == gt_class_ids[:, None]

    p = len(pred_class_ids)
    gt_matches = -np.ones(g, np.int32)
    pred_taken = np.zeros(p, bool)
    for i in range(g):
        for j in np.argsort(overlaps[i])[::-1]:
            if pred_taken[j] or not cls_ok[i, j]:
                continue
            gt_matches[i] = j
            pred_taken[j] = True
            break
    return gt_matches, order


# ---------------------------------------------------------------------------
# full evaluation
# ---------------------------------------------------------------------------

def compute_independent_map(final_results: Sequence[dict],
                            synset_names: Sequence[str] = SYNSET_NAMES,
                            degree_thresholds: Sequence[float] = range(0, 61),
                            shift_thresholds: Sequence[float] = tuple(i / 2 for i in range(21)),
                            iou_3d_thresholds: Sequence[float] = tuple(i / 100 for i in range(101)),
                            iou_pose_thres: float = 0.1,
                            use_matches_for_pose: bool = True,
                            logger=None, plot_figure: bool = False,
                            log_dir: str | None = None):
    """Per-class + mean AP grids (evaluation_utils.py:735-1020).

    Returns (iou_3d_aps (C+1, I), pose_aps (C+1, D, S)); index -1 is the mean
    over foreground classes; degree/shift lists get the +[360]/+[100] pads.
    """
    num_classes = len(synset_names)
    degree_list = np.asarray(list(degree_thresholds) + [360], np.float64)
    shift_list = np.asarray(list(shift_thresholds) + [100], np.float64)
    iou_list = np.asarray(list(iou_3d_thresholds), np.float64)
    thres_ind = list(iou_list).index(iou_pose_thres) if use_matches_for_pose else None

    iou_pm = [[] for _ in range(num_classes)]   # (I, P_i) chunks
    iou_sc = [[] for _ in range(num_classes)]   # (P_i,) chunks
    iou_ngt = [0] * num_classes
    pose_pm = [[] for _ in range(num_classes)]  # (D, S, P_i) chunks
    pose_sc = [[] for _ in range(num_classes)]
    pose_ngt = [0] * num_classes

    for result in final_results:
        gt_class_ids = np.asarray(result["gt_class_ids"], np.int32).reshape(-1)
        gt_rts = np.asarray(result["gt_RTs"], np.float64).reshape(-1, 4, 4)
        gt_scales = np.asarray(result["gt_scales"], np.float64).reshape(-1, 3)
        gt_handle = np.asarray(result.get(
            "gt_handle_visibility", np.ones_like(gt_class_ids))).reshape(-1)

        pred_class_ids = np.asarray(result["pred_class_ids"], np.int32).reshape(-1)
        pred_rts = np.asarray(result["pred_RTs"], np.float64).reshape(-1, 4, 4)
        pred_scales = np.asarray(result["pred_scales"], np.float64).reshape(-1, 3)
        pred_scores = np.asarray(result["pred_scores"], np.float64).reshape(-1)

        if len(gt_class_ids) == 0 and len(pred_class_ids) == 0:
            continue

        for cls_id in range(1, num_classes):
            gsel = gt_class_ids == cls_id
            psel = pred_class_ids == cls_id
            c_gt_rts, c_gt_scales = gt_rts[gsel], gt_scales[gsel]
            c_pred_rts, c_pred_scales = pred_rts[psel], pred_scales[psel]
            c_scores = pred_scores[psel]

            if synset_names[cls_id] == "mug":
                c_handle = gt_handle[gsel]
            else:
                c_handle = np.ones(int(gsel.sum()))

            # sort preds by score desc (compute_3d_matches, :529-539)
            order = np.argsort(c_scores)[::-1]
            c_pred_rts, c_pred_scales = c_pred_rts[order], c_pred_scales[order]
            c_scores = c_scores[order]

            name = synset_names[cls_id]
            sym = np.asarray([(name in _Y_SYM_CLASSES)
                              or (name == "mug" and h == 0) for h in c_handle], bool)

            overlaps = compute_3d_iou_matrix(
                c_pred_rts, c_pred_scales, c_gt_rts, c_gt_scales, sym)
            gt_m, pred_m = greedy_match_iou(overlaps, iou_list)

            iou_pm[cls_id].append(pred_m)
            iou_sc[cls_id].append(np.asarray(c_scores))
            iou_ngt[cls_id] += len(c_gt_rts)

            if use_matches_for_pose:
                pkeep = pred_m[thres_ind] > -1
                gkeep = gt_m[thres_ind] > -1
                c_pred_rts, c_scores = c_pred_rts[pkeep], c_scores[pkeep]
                c_gt_rts, c_handle = c_gt_rts[gkeep], c_handle[gkeep]
                sym = sym[gkeep]

            errors = compute_rt_errors(c_pred_rts, c_gt_rts, sym)
            _, pose_pred_m = greedy_match_pose(errors, degree_list, shift_list)
            pose_pm[cls_id].append(pose_pred_m)
            pose_sc[cls_id].append(np.asarray(c_scores))
            pose_ngt[cls_id] += len(c_gt_rts)

    iou_aps = np.zeros((num_classes + 1, len(iou_list)))
    pose_aps = np.zeros((num_classes + 1, len(degree_list), len(shift_list)))
    for cls_id in range(1, num_classes):
        pm = (np.concatenate(iou_pm[cls_id], axis=-1)
              if iou_pm[cls_id] else np.zeros((len(iou_list), 0)))
        sc = (np.concatenate(iou_sc[cls_id])
              if iou_sc[cls_id] else np.zeros(0))
        iou_aps[cls_id] = ap_from_matches(pm, sc, iou_ngt[cls_id])

        ppm = (np.concatenate(pose_pm[cls_id], axis=-1)
               if pose_pm[cls_id] else np.zeros((len(degree_list), len(shift_list), 0)))
        psc = (np.concatenate(pose_sc[cls_id])
               if pose_sc[cls_id] else np.zeros(0))
        pose_aps[cls_id] = ap_from_matches(ppm, psc, pose_ngt[cls_id])

    iou_aps[-1] = iou_aps[1:-1].mean(axis=0)
    pose_aps[-1] = pose_aps[1:-1].mean(axis=0)

    _log_results(iou_aps, pose_aps, list(iou_list), list(degree_list),
                 list(shift_list), synset_names, logger)
    if plot_figure and log_dir is not None:
        _plot_curves(iou_aps, pose_aps, list(iou_list), list(degree_list),
                     list(shift_list), synset_names, log_dir)
    return iou_aps, pose_aps


def headline_metrics(iou_aps, pose_aps, iou_list, degree_list, shift_list) -> dict:
    """Headline numbers; entries whose threshold isn't in the grids are omitted."""
    out = {}
    for name, v in (("IoU25", 0.25), ("IoU50", 0.5), ("IoU75", 0.75)):
        if v in iou_list:
            out[name] = iou_aps[-1, iou_list.index(v)] * 100
    for name, d, s in (("5d2cm", 5, 2), ("5d5cm", 5, 5), ("10d2cm", 10, 2),
                       ("10d5cm", 10, 5), ("10d10cm", 10, 10)):
        if d in degree_list and s in shift_list:
            out[name] = pose_aps[-1, degree_list.index(d), shift_list.index(s)] * 100
    return out


def _log_results(iou_aps, pose_aps, iou_list, degree_list, shift_list,
                 synset_names, logger) -> None:
    out = logger.warning if logger is not None else print
    names = {"IoU25": "3D IoU at 25", "IoU50": "3D IoU at 50", "IoU75": "3D IoU at 75",
             "5d2cm": "5 degree, 2cm", "5d5cm": "5 degree, 5cm",
             "10d2cm": "10 degree, 2cm", "10d5cm": "10 degree, 5cm",
             "10d10cm": "10 degree, 10cm"}
    m = headline_metrics(iou_aps, pose_aps, iou_list, degree_list, shift_list)
    for k, v in m.items():
        out("{}: {:.1f}".format(names[k], v))
    out("####### Per Class result ###################")
    for idx in range(1, len(synset_names)):
        out("category {}".format(synset_names[idx]))
        if 0.5 in iou_list:
            out("3D IoU at 50: {:.1f}".format(iou_aps[idx, iou_list.index(0.5)] * 100))
        if 0.75 in iou_list:
            out("3D IoU at 75: {:.1f}".format(iou_aps[idx, iou_list.index(0.75)] * 100))
        if 5 in degree_list and 2 in shift_list:
            out("5 degree, 2cm: {:.1f}".format(
                pose_aps[idx, degree_list.index(5), shift_list.index(2)] * 100))
        if 10 in degree_list and 2 in shift_list:
            out("10 degree, 2cm: {:.1f}".format(
                pose_aps[idx, degree_list.index(10), shift_list.index(2)] * 100))


def _plot_curves(iou_aps, pose_aps, iou_list, degree_list, shift_list,
                 synset_names, log_dir: str) -> None:
    """AP-curve PNGs (evaluation_utils.py:879-951)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(30, 10))
    ax = plt.subplot(131)
    plt.ylabel("AP"); plt.ylim((0, 1)); plt.xlabel("3D IoU thresholds")
    for cls_id in range(1, len(synset_names)):
        ax.plot(iou_list, iou_aps[cls_id], label=synset_names[cls_id])
    ax.plot(iou_list, iou_aps[-1], label="mean")
    ax2 = plt.subplot(132)
    plt.ylim((0, 1)); plt.xlabel("Rotation/degree")
    for cls_id in range(1, len(synset_names)):
        ax2.plot(degree_list[:-1], pose_aps[cls_id, :-1, -1], label=synset_names[cls_id])
    ax2.plot(degree_list[:-1], pose_aps[-1, :-1, -1], label="mean")
    ax3 = plt.subplot(133)
    plt.ylim((0, 1)); plt.xlabel("translation/cm")
    for cls_id in range(1, len(synset_names)):
        ax3.plot(shift_list[:-1], pose_aps[cls_id, -1, :-1], label=synset_names[cls_id])
    ax3.plot(shift_list[:-1], pose_aps[-1, -1, :-1], label="mean")
    ax3.legend(loc="lower right")
    vis = os.path.join(log_dir, "visual")
    os.makedirs(vis, exist_ok=True)
    fig.savefig(os.path.join(
        vis, "mAP_{}-{}cm.png".format(shift_list[0], shift_list[-2])))
    plt.close(fig)


def evaluate(path: str, logger=None, plot_figure: bool = True):
    """Glob ``results*.pkl`` under ``path`` and compute the full metric grids
    (evaluation_utils.py:1023-1072)."""
    result_pkl_list = sorted(glob.glob(os.path.join(path, "results*.pkl")))
    final_results = []
    for pkl_path in result_pkl_list:
        with open(pkl_path, "rb") as f:
            result = pickle.load(f)
        # a pkl may hold one dict or a list of dicts (the reference checks the
        # list case AFTER dict-indexing it, evaluation_utils.py:1041-1052 — a
        # crash on list pkls; fixed here by normalizing first)
        items = result if isinstance(result, list) else [result]
        for item in items:
            if "gt_handle_visibility" not in item:
                item["gt_handle_visibility"] = np.ones_like(item["gt_class_ids"])
        final_results += items
    iou_aps, pose_aps = compute_independent_map(
        final_results, SYNSET_NAMES,
        degree_thresholds=list(range(0, 61)),
        shift_thresholds=[i / 2 for i in range(21)],
        iou_3d_thresholds=[i / 100 for i in range(101)],
        logger=logger, plot_figure=plot_figure, log_dir=path)
    return iou_aps, pose_aps
