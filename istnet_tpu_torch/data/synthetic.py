"""Synthetic NOCS-format test trees (exact on-disk file formats).

The port's own copy of the test side of ``istnet_tpu/data/synthetic.py``:
color/depth/mask/coord PNGs, ``_label.pkl`` ground truth, the Mask-RCNN
``results_*.pkl`` and ``obj_models/real_test.pkl``, from random pixels, so
that the inference loops and the evaluation run end to end without the NOCS
download.
"""

from __future__ import annotations

import os
import pickle

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
