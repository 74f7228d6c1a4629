"""NOCS test frames with their Mask-RCNN detections (the port's own copy of
the test side of ``istnet_tpu/data/dataset.py``; ``TrainingDataset`` is not
here yet).

``TestDataset`` yields, per image, either the host-preprocessed instance
crops (depth fill through OpenCV, >16 valid pixels, ``sample_num`` points,
resized RGB) or, with ``device_preprocess=True``, the raw arrays that
``data/device_preprocess.py`` and ``eval/test_loop.py`` turn into model
inputs on the device. Both carry the ``gt_*`` / ``pred_*`` arrays of the
segmentation pkl to the metric stage.
"""

from __future__ import annotations

import glob
import os
import pickle

import cv2
import numpy as np

from istnet_tpu_torch.data.depth_utils import (
    backproject, fill_missing, get_bbox, load_depth)
from istnet_tpu_torch.data.transforms import normalize_image

CAT_NAMES = ["bottle", "bowl", "camera", "can", "laptop", "mug"]
CAMERA_INTRINSICS = [577.5, 577.5, 319.5, 239.5]
REAL_INTRINSICS = [591.0125, 590.16775, 322.525, 244.11084]


def update_choose_for_resize(choose: np.ndarray, crop_w: int, img_size: int) -> np.ndarray:
    """Remap flat crop indices to the resized crop."""
    ratio = img_size / crop_w
    col_idx = choose % crop_w
    row_idx = choose // crop_w
    return (np.floor(row_idx * ratio) * img_size + np.floor(col_idx * ratio)).astype(np.int64)


class TestDataset:
    """Per-image test data with Mask-RCNN detections.

    With ``device_preprocess=True`` the per-instance host work (depth fill,
    crop, sampling, resize) is skipped; ``__getitem__`` returns raw arrays
    (uint8 rgb, raw depth, per-instance masks, boxes) for the device-side
    pipeline, which produces the model inputs on the device.
    """

    __test__ = False  # not a pytest class

    def __init__(self, config, data_dir: str, seed: int | None = 0,
                 device_preprocess: bool = False):
        self.data_dir = data_dir
        self.img_size = config.img_size
        self.sample_num = config.sample_num
        self.intrinsics = REAL_INTRINSICS
        self.norm_scale = 1000.0
        self.base_seed = 0 if seed is None else int(seed)
        self.device_preprocess = device_preprocess

        pkls = glob.glob(os.path.join(data_dir, "data", "segmentation_results",
                                      "test_trainedwithMask", "results_*.pkl"))
        self.result_pkl_list = sorted(pkls)

        model_path = os.path.join(data_dir, "data", "obj_models", "real_test.pkl")
        self.models = {}
        if os.path.exists(model_path):
            with open(model_path, "rb") as f:
                self.models = pickle.load(f)

    def __len__(self) -> int:
        return len(self.result_pkl_list)

    def __getitem__(self, index: int) -> dict:
        # per-call RNG: thread-safe + order-independent determinism
        rng = np.random.RandomState((self.base_seed * 1000003 + index) & 0x7FFFFFFF)
        path = self.result_pkl_list[index]
        with open(path, "rb") as f:
            data = pickle.load(f)
        image_path = os.path.join(self.data_dir, data["image_path"])
        image_path = image_path.replace("/data/real/", "/data/Real/")

        pred_mask = data["pred_masks"]
        num_instance = len(data["pred_class_ids"])

        rgb_full = cv2.imread(image_path + "_color.png")[:, :, :3][:, :, ::-1]

        raw_depth = load_depth(image_path)
        if raw_depth is None:
            # self-heal a missing/corrupt depth PNG: emit an empty result so
            # the image still contributes its GTs to the metric (the
            # reference test path would crash here)
            return {"index": index, "empty": True, "gt": data,
                    "flag_instance": np.zeros(num_instance, bool),
                    "image_path": image_path}

        if self.device_preprocess:
            return {
                "index": index,
                "empty": num_instance == 0,
                "raw": True,
                "rgb_full": np.ascontiguousarray(rgb_full, np.uint8),
                "depth_raw": raw_depth.astype(np.float32),
                "masks": np.transpose(pred_mask, (2, 0, 1)).astype(bool),
                "bboxes": np.asarray(data["pred_bboxes"], np.int32),
                "category_label": np.asarray(data["pred_class_ids"], np.int64) - 1,
                "gt": data,
                "image_path": image_path,
                "ori_img": rgb_full[:, :, ::-1].copy(),
            }
        coord = cv2.imread(image_path + "_coord.png")[:, :, :3][:, :, (2, 1, 0)]
        coord = coord.astype(np.float32) / 255.0
        coord[:, :, 2] = 1 - coord[:, :, 2]

        depth = fill_missing(raw_depth, self.norm_scale, 1)
        pts_map = backproject(depth, self.intrinsics, self.norm_scale)

        all_pts, all_rgb, all_nocs, all_choose, all_cat_ids = [], [], [], [], []
        flag_instance = np.zeros(num_instance, bool)
        for j in range(num_instance):
            mask = (pred_mask[:, :, j] > 0) & (depth > 0)
            rmin, rmax, cmin, cmax = get_bbox(data["pred_bboxes"][j])
            choose = mask[rmin:rmax, cmin:cmax].flatten().nonzero()[0]
            if len(choose) <= 16:
                continue
            choose = choose[rng.choice(len(choose), self.sample_num,
                                       replace=len(choose) <= self.sample_num)]
            inst_pts = pts_map[rmin:rmax, cmin:cmax].reshape(-1, 3)[choose]
            inst_nocs = coord[rmin:rmax, cmin:cmax].reshape(-1, 3)[choose] - 0.5
            inst_rgb = cv2.resize(np.ascontiguousarray(rgb_full[rmin:rmax, cmin:cmax]),
                                  (self.img_size, self.img_size),
                                  interpolation=cv2.INTER_LINEAR)
            inst_rgb = normalize_image(inst_rgb.astype(np.uint8))
            choose = update_choose_for_resize(choose, rmax - rmin, self.img_size)

            all_pts.append(inst_pts.astype(np.float32))
            all_rgb.append(inst_rgb.astype(np.float32))
            all_nocs.append(inst_nocs.astype(np.float32))
            all_choose.append(choose)
            all_cat_ids.append(np.int64(data["pred_class_ids"][j] - 1))
            flag_instance[j] = True

        if not all_pts:  # no usable instance in this image
            return {"index": index, "empty": True, "gt": data,
                    "flag_instance": flag_instance, "image_path": image_path}

        return {
            "index": index,
            "empty": False,
            "pts": np.stack(all_pts),
            "rgb": np.stack(all_rgb),
            "nocs": np.stack(all_nocs),
            "choose": np.stack(all_choose),
            "category_label": np.asarray(all_cat_ids),
            "gt": data,  # carries gt_* and pred_* arrays to the metric stage
            "flag_instance": flag_instance,
            "image_path": image_path,
            "ori_img": rgb_full[:, :, ::-1].copy(),  # BGR, for visualization
        }
