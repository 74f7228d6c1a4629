"""Synthetic NOCS-format train and test trees (exact on-disk file formats).

The port's own copy of ``istnet_tpu/data/synthetic.py``'s trees:
color/depth/mask/coord PNGs, ``_label.pkl`` ground truth, CAMERA composed
depths, the Mask-RCNN ``results_*.pkl`` and the ``obj_models/*.pkl``
vertex files, from random pixels, so that training, the inference loops
and the evaluation run end to end without the NOCS download; and the raw
(pre-annotation) NOCS tree of ``build_raw_prep_tree``, with depth and NOCS
maps that agree geometrically, for the data preparation.
"""

from __future__ import annotations

import os
import pickle
import shutil

import cv2
import numpy as np


def write_scene(img_dir: str, stem: str, n_inst: int = 2, seed: int = 0,
                coord: bool = False) -> dict:
    """One scene: color/depth/mask[(coord)] PNGs + _label.pkl; returns gts."""
    rng = np.random.RandomState(seed)
    os.makedirs(img_dir, exist_ok=True)
    base = os.path.join(img_dir, stem)

    color = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    cv2.imwrite(base + "_color.png", color)

    depth = np.zeros((480, 640), np.uint16)
    mask = np.full((480, 640, 3), 255, np.uint8)
    bboxes = []
    for inst in range(n_inst):
        y0, x0 = 120 + 120 * inst, 160 + 150 * inst
        depth[y0:y0 + 100, x0:x0 + 100] = 800 + 200 * inst
        mask[y0 + 10:y0 + 90, x0 + 10:x0 + 90, 2] = inst + 1
        bboxes.append([y0 + 10, x0 + 10, y0 + 90, x0 + 90])
    depth[0:100] = 0
    cv2.imwrite(base + "_depth.png", depth)
    cv2.imwrite(base + "_mask.png", mask)
    if coord:
        cmap = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
        cv2.imwrite(base + "_coord.png", cmap)

    gts = {
        "class_ids": [1 + inst for inst in range(n_inst)],
        "instance_ids": [1 + inst for inst in range(n_inst)],
        "model_list": [f"model_{i}" for i in range(n_inst)],
        "bboxes": np.asarray(bboxes, np.int32),
        "scales": np.asarray([1.0] * n_inst, np.float32),
        "sizes": np.tile(np.asarray([0.1, 0.2, 0.1], np.float32), (n_inst, 1)),
        "rotations": np.tile(np.eye(3, dtype=np.float32), (n_inst, 1, 1)),
        "translations": np.asarray([[0.0, 0.0, 0.8 + 0.2 * i] for i in range(n_inst)],
                                   np.float32),
    }
    with open(base + "_label.pkl", "wb") as f:
        pickle.dump(gts, f)
    return gts


def write_seg_result(seg_dir: str, gts: dict, stem: str,
                     scene: str = "scene_1") -> None:
    """Mask-RCNN segmentation result pkl for a written test scene."""
    n = len(gts["class_ids"])
    pred_masks = np.zeros((480, 640, n), np.uint8)
    for j, (y0, x0, y1, x1) in enumerate(gts["bboxes"]):
        pred_masks[y0:y1, x0:x1, j] = 1
    rts = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    rts[:, :3, 3] = gts["translations"]
    result = {
        "image_path": f"data/real/test/{scene}/{stem}",
        "pred_masks": pred_masks,
        "pred_class_ids": np.asarray(gts["class_ids"]),
        "pred_bboxes": gts["bboxes"],
        "pred_scores": np.ones(n, np.float32),
        "gt_class_ids": np.asarray(gts["class_ids"]),
        "gt_bboxes": gts["bboxes"],
        "gt_RTs": rts,
        "gt_scales": np.tile(np.asarray([0.1, 0.2, 0.1], np.float32), (n, 1)),
        "gt_handle_visibility": np.ones(n, np.int64),
    }
    os.makedirs(seg_dir, exist_ok=True)
    with open(os.path.join(seg_dir, f"results_test_{scene}_{stem}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _write_models(data_dir: str, names: tuple[str, ...]) -> None:
    models = {f"model_{i}": np.random.RandomState(i).rand(64, 3).astype(np.float32) - 0.5
              for i in range(2)}
    os.makedirs(os.path.join(data_dir, "obj_models"), exist_ok=True)
    for name in names:
        with open(os.path.join(data_dir, "obj_models", name), "wb") as f:
            pickle.dump(models, f)


def build_train_trees(data_dir: str, n_scenes: int = 2) -> None:
    """Real + CAMERA train trees (with composed depths) + model pkls, the
    layout ``TrainingDataset`` reads (``data_dir`` must contain ``/data/``
    for the composed-depth path)."""
    stems = [f"{i:04d}" for i in range(n_scenes)]
    real_dir = os.path.join(data_dir, "Real", "train", "scene_1")
    for i, stem in enumerate(stems):
        write_scene(real_dir, stem, seed=i)
    with open(os.path.join(data_dir, "Real", "train_list.txt"), "w") as f:
        f.writelines(f"train/scene_1/{s}\n" for s in stems)

    cam_dir = os.path.join(data_dir, "CAMERA", "train", "00000")
    comp_dir = os.path.join(data_dir, "camera_full_depths", "train", "00000")
    os.makedirs(comp_dir, exist_ok=True)
    for i, stem in enumerate(stems):
        write_scene(cam_dir, stem, seed=10 + i)
        shutil.copy(os.path.join(cam_dir, f"{stem}_depth.png"),
                    os.path.join(comp_dir, f"{stem}_composed.png"))
    with open(os.path.join(data_dir, "CAMERA", "train_list.txt"), "w") as f:
        f.writelines(f"train/00000/{s}\n" for s in stems)

    _write_models(data_dir, ("real_train.pkl", "camera_train.pkl"))


def build_test_tree(data_dir: str, n_scenes: int = 2, n_inst: int = 2) -> None:
    """Real test tree + segmentation result pkls + model pkl."""
    stems = [f"{i:04d}" for i in range(n_scenes)]
    test_dir = os.path.join(data_dir, "data", "Real", "test", "scene_1")
    seg_dir = os.path.join(data_dir, "data", "segmentation_results",
                           "test_trainedwithMask")
    for i, stem in enumerate(stems):
        gts = write_scene(test_dir, stem, n_inst=n_inst, seed=20 + i,
                          coord=True)
        write_seg_result(seg_dir, gts, stem)
    _write_models(os.path.join(data_dir, "data"), ("real_test.pkl",))


def _small_rotation(seed: int) -> np.ndarray:
    """A modest random rotation matrix (Rodrigues of a small axis-angle)."""
    rng = np.random.RandomState(seed)
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    angle = 0.2 + 0.5 * rng.rand()
    rvec = (axis * angle).reshape(3, 1)
    r, _ = cv2.Rodrigues(rvec)
    return r


def write_raw_scene(img_dir: str, stem: str, intrinsics: np.ndarray,
                    instances: list[dict], seed: int = 0) -> dict:
    """One RAW (pre-annotation) NOCS scene: color/depth/mask/coord PNGs +
    _meta.txt, with GEOMETRICALLY CONSISTENT depth<->NOCS correspondences so
    the offline annotation stages (Umeyama-RANSAC, solvePnP — reference
    ``data_processing.py:161-267``) recover a real pose from it.

    Each entry of ``instances``: {inst_id, cls_id, meta_tail (str appended to
    "inst cls"), region (y0, x0, h, w)}, optional {in_mask: False} (meta line
    whose instance is absent from the mask), {sparse_depth: k} (only k valid
    depth px — k<64 gets the instance skipped), {z0: mm}. The NOCS coord map
    is built by back-projecting the depth plane and mapping through a random
    similarity (R, t, s): coord = R^T (X - t)/s + 0.5, z-flip encoded exactly
    like the loader expects (``data_processing.py:77-82``). Returns
    {inst_id: (s_mm, R, t_mm)} ground truths.
    """
    rng = np.random.RandomState(seed)
    os.makedirs(img_dir, exist_ok=True)
    base = os.path.join(img_dir, stem)
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]

    color = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    depth = np.zeros((480, 640), np.uint16)
    mask = np.full((480, 640, 3), 255, np.uint8)   # R channel = instance id
    coord = np.zeros((480, 640, 3), np.uint8)      # BGR on disk
    gts = {}
    meta_lines = []

    for k, inst in enumerate(instances):
        inst_id, cls_id = inst["inst_id"], inst["cls_id"]
        meta_lines.append(f"{inst_id} {cls_id} {inst['meta_tail']}\n")
        if not inst.get("in_mask", True):
            continue
        y0, x0, h, w = inst["region"]
        vs, us = np.meshgrid(np.arange(y0, y0 + h), np.arange(x0, x0 + w),
                             indexing="ij")
        z0 = inst.get("z0", 800 + 150 * k)
        z = (z0 + 2 * (us - x0) + (vs - y0)).astype(np.uint16)  # mm plane
        x_mm = (us - cx) * z.astype(np.float64) / fx
        y_mm = (vs - cy) * z.astype(np.float64) / fy
        pts = np.stack([x_mm, y_mm, z.astype(np.float64)], axis=-1)  # (h,w,3)

        t_mm = pts.reshape(-1, 3).mean(0)
        radius = np.linalg.norm(pts.reshape(-1, 3) - t_mm, axis=1).max()
        s_mm = 2.1 * radius
        r = _small_rotation(seed * 31 + k)
        nocs = (pts - t_mm) @ r / s_mm  # == R^T (X - t) / s, in [-0.48, 0.48]

        # encode: loader reads BGR->(R,G,B) = (x, y, z_enc)/255, z = 1 - z_enc
        coord[vs, us, 2] = np.round((nocs[..., 0] + 0.5) * 255).astype(np.uint8)
        coord[vs, us, 1] = np.round((nocs[..., 1] + 0.5) * 255).astype(np.uint8)
        coord[vs, us, 0] = np.round((0.5 - nocs[..., 2]) * 255).astype(np.uint8)
        mask[vs, us, 2] = inst_id
        depth[vs, us] = z
        sparse = inst.get("sparse_depth")
        if sparse is not None:  # keep only `sparse` valid depth px
            keep = np.zeros(h * w, bool)
            keep[rng.choice(h * w, sparse, replace=False)] = True
            depth[vs, us] = np.where(keep.reshape(h, w), z, 0)
        gts[inst_id] = (s_mm, r, t_mm)

    cv2.imwrite(base + "_color.png", color)
    cv2.imwrite(base + "_depth.png", depth)
    cv2.imwrite(base + "_mask.png", mask)
    cv2.imwrite(base + "_coord.png", coord)
    with open(base + "_meta.txt", "w") as f:
        f.writelines(meta_lines)
    return gts


def build_raw_prep_tree(root: str) -> None:
    """A RAW NOCS download tree (pre-``data_processing``) exercising every
    branch of the offline annotation stages (reference
    ``data_processing.py:16-384``): CAMERA train (Umeyama-RANSAC incl. the
    bad-mug skip, a bad render, a <64-px instance, cls-0 and absent-instance
    meta lines, missing images), Real train (solvePnP), CAMERA val + Real
    test (handle-visibility copy from NOCS result pkls, incl. the real_val
    ``.npz`` scale branch). Geometry is consistent (see ``write_raw_scene``)
    so the fits recover real poses. ``cli/data_processing.py`` of either
    package runs on a copy of this tree.
    """
    cam_k = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]])
    real_k = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084],
                       [0, 0, 1]])

    def bbox_txt(path: str, size) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        size = np.asarray(size, np.float64)
        np.savetxt(path, np.stack([size / 2, -size / 2]))

    om = os.path.join(root, "obj_models")
    for folder, model, size in [
            ("03001627", "modelA", (0.3, 0.5, 0.3)),
            ("02876657", "modelB", (0.2, 0.6, 0.2)),
            ("03797390", "b9be7cfe653740eb7633a2dd89cec754", (0.3, 0.3, 0.3)),
            ("02880940", "modelC", (0.4, 0.2, 0.4)),
            ("02942699", "modelD", (0.3, 0.2, 0.15))]:
        bbox_txt(os.path.join(om, "train", folder, model, "bbox.txt"), size)
    bbox_txt(os.path.join(om, "val", "02876657", "modelV", "bbox.txt"),
             (0.25, 0.55, 0.25))
    os.makedirs(os.path.join(om, "real_train"), exist_ok=True)
    for model, size in [("mug_a_norm", (0.2, 0.18, 0.15)),
                        ("bottle_b_norm", (0.1, 0.35, 0.1)),
                        ("laptop_c_norm", (0.4, 0.3, 0.35))]:
        np.savetxt(os.path.join(om, "real_train", model + ".txt"),
                   np.asarray(size, np.float64))
    os.makedirs(os.path.join(om, "real_test"), exist_ok=True)
    np.savetxt(os.path.join(om, "real_test", "mug_d_norm.txt"),
               np.asarray((0.22, 0.2, 0.16), np.float64))
    os.makedirs(os.path.join(om, "real_val"), exist_ok=True)
    np.savez(os.path.join(om, "real_val", "scan_e_norm.npz"),
             scale=np.asarray((0.12, 0.4, 0.12), np.float64))
    # model vertex pkls for annotate_test_data's model_sizes
    rngm = np.random.RandomState(3)
    with open(os.path.join(om, "camera_val.pkl"), "wb") as f:
        pickle.dump({"modelV": rngm.rand(64, 3).astype(np.float32) - 0.5}, f)
    with open(os.path.join(om, "real_test.pkl"), "wb") as f:
        pickle.dump({"mug_d_norm": rngm.rand(64, 3).astype(np.float32) - 0.5,
                     "scan_e_norm.npz": rngm.rand(48, 3).astype(np.float32) - 0.5},
                    f)
    # model-vertex pkls consumed by TrainingDataset (dataset.py:18-56), so the
    # produced labels can be driven through the actual training data layer
    with open(os.path.join(om, "real_train.pkl"), "wb") as f:
        pickle.dump({m: rngm.rand(64, 3).astype(np.float32) - 0.5
                     for m in ("mug_a_norm", "bottle_b_norm", "laptop_c_norm")}, f)
    with open(os.path.join(om, "camera_train.pkl"), "wb") as f:
        pickle.dump({m: rngm.rand(64, 3).astype(np.float32) - 0.5
                     for m in ("modelA", "modelB", "modelC", "modelD")}, f)

    # --- CAMERA train: 3 scenes present out of the 10 the list will name
    cam_dir = os.path.join(root, "CAMERA", "train", "00000")
    write_raw_scene(cam_dir, "0000", cam_k, [
        dict(inst_id=1, cls_id=1, meta_tail="03001627 modelA",
             region=(100, 100, 60, 80)),
        dict(inst_id=2, cls_id=2, meta_tail="02876657 modelB",
             region=(250, 300, 70, 70)),
        # bad CAMERA mug: scale file read, then skipped (dp.py:121-122)
        dict(inst_id=3, cls_id=6,
             meta_tail="03797390 b9be7cfe653740eb7633a2dd89cec754",
             region=(350, 450, 50, 50)),
        # background (cls 0) and absent-from-mask meta lines
        dict(inst_id=4, cls_id=0, meta_tail="03001627 modelA", in_mask=False),
        dict(inst_id=5, cls_id=1, meta_tail="03001627 modelA", in_mask=False),
    ], seed=1)
    # bad render: instance wider than 600 px drops the IMAGE (dp.py:134-136)
    write_raw_scene(cam_dir, "0001", cam_k, [
        dict(inst_id=1, cls_id=1, meta_tail="03001627 modelA",
             region=(50, 10, 40, 620)),
    ], seed=2)
    write_raw_scene(cam_dir, "0002", cam_k, [
        dict(inst_id=1, cls_id=3, meta_tail="02880940 modelC",
             region=(120, 200, 64, 64)),
        # <64 valid depth px: instance skipped (dp.py:137-140)
        dict(inst_id=2, cls_id=4, meta_tail="02942699 modelD",
             region=(300, 100, 50, 60), sparse_depth=30),
    ], seed=3)

    # --- CAMERA val (for annotate_test_data)
    write_raw_scene(os.path.join(root, "CAMERA", "val", "00000"), "0000",
                    cam_k, [
        dict(inst_id=1, cls_id=2, meta_tail="02876657 modelV",
             region=(200, 250, 60, 60)),
    ], seed=4)

    # --- Real train (solvePnP)
    real_dir = os.path.join(root, "Real", "train", "scene_1")
    write_raw_scene(real_dir, "0000", real_k, [
        dict(inst_id=1, cls_id=6, meta_tail="mug_a_norm",
             region=(150, 150, 70, 70)),
        dict(inst_id=2, cls_id=2, meta_tail="bottle_b_norm",
             region=(300, 400, 60, 60)),
    ], seed=5)
    write_raw_scene(real_dir, "0001", real_k, [
        dict(inst_id=1, cls_id=5, meta_tail="laptop_c_norm",
             region=(100, 350, 80, 90)),
    ], seed=6)

    # --- Real test (handle-visibility copy; one .npz-scale instance)
    write_raw_scene(os.path.join(root, "Real", "test", "scene_1"), "0000",
                    real_k, [
        dict(inst_id=1, cls_id=6, meta_tail="mug_d_norm",
             region=(140, 120, 70, 70)),
        dict(inst_id=2, cls_id=1, meta_tail="scan_e_norm.npz",
             region=(280, 380, 60, 60)),
    ], seed=7)

    # --- NOCS result pkls consumed by annotate_test_data (dp.py:311-342).
    # bboxes of a full-region instance are [y0, x0, y0+h, x0+w]; offsets <= 5
    # exercise the |diff|<=5 matching, the leading distractor the loop order.
    def nocs_result(path: str, entries: list[tuple[int, tuple, float, int, int]]):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        rng = np.random.RandomState(11)
        gt_rts = []
        for _, _, s, _, rot_seed in entries:
            rt = np.eye(4)
            rt[:3, :3] = s * _small_rotation(rot_seed)
            rt[:3, 3] = rng.rand(3)
            gt_rts.append(rt)
        with open(path, "wb") as f:
            pickle.dump({
                "gt_class_ids": np.asarray([e[0] for e in entries], np.int32),
                "gt_bboxes": np.asarray([e[1] for e in entries], np.int32),
                "gt_RTs": np.asarray(gt_rts),
                "gt_handle_visibility": np.asarray([e[3] for e in entries],
                                                   np.int32),
            }, f)

    nocs_result(os.path.join(root, "results", "nocs_results", "val",
                             "results_val_00000_0000.pkl"),
                [(5, (0, 0, 10, 10), 0.5, 1, 91),          # distractor
                 (2, (201, 251, 261, 309), 0.31, 1, 92)])  # match (|d|=4)
    nocs_result(os.path.join(root, "results", "nocs_results", "real_test",
                             "results_test_scene_1_0000.pkl"),
                [(6, (141, 120, 209, 190), 0.27, 0, 93),   # match (|d|=2)
                 (1, (280, 381, 340, 440), 0.44, 1, 94)])  # match (|d|=1)
