"""NOCS datasets on the host: training (CAMERA syn + Real) and test (the
port's own copy of ``istnet_tpu/data/dataset.py``).

``TrainingDataset`` yields one instance a sample: depth (the composed depth
for CAMERA), the morphological fill, one instance of ``_label.pkl`` +
``_mask.png``, the square crop, ``sample_num`` mask pixels back-projected
with clipped jitter, the 192 crop with the PIL colour jitter and ImageNet
normalisation, ``choose`` remapped to the resized crop, the rotation of a
symmetric class (bottle, bowl, can) made canonical about y, the NOCS
points ``qo = (pts - t) / ||s|| @ R``, and the FS-Net bb / rt augmentation.
A sample whose depth or mask is missing retries at a random index (an
index the retry chain has tried draws again, where JAX would recurse
forever).
``reset()`` resamples the epoch. Every draw comes from a ``RandomState``
seeded per sample from ``hash((seed, image, index))``, so the samples
equal the JAX package's bit for bit and are safe under threaded loaders.

``TestDataset`` yields, per image, either the host-preprocessed instance
crops (depth fill through OpenCV, >16 valid pixels, ``sample_num`` points,
resized RGB) or, with ``device_preprocess=True``, the raw arrays that
``data/device_preprocess.py`` and ``eval/test_loop.py`` turn into model
inputs on the device. Both carry the ``gt_*`` / ``pred_*`` arrays of the
segmentation pkl to the metric stage.
"""

from __future__ import annotations

import glob
import math
import os
import pickle

import cv2
import numpy as np

from istnet_tpu_torch.data.augment import data_augment, generate_aug_parameters
from istnet_tpu_torch.data.depth_utils import (
    backproject, fill_missing, get_bbox, load_composed_depth, load_depth)
from istnet_tpu_torch.data.transforms import color_jitter, normalize_image

CAT_NAMES = ["bottle", "bowl", "camera", "can", "laptop", "mug"]
CAMERA_INTRINSICS = [577.5, 577.5, 319.5, 239.5]
REAL_INTRINSICS = [591.0125, 590.16775, 322.525, 244.11084]
SYM_IDS = (0, 1, 3)  # bottle, bowl, can (0-indexed)

DEVICE_PIPELINE_NOT_YET = (
    "the train-side device pipeline (use_device_preprocess / use_device_aug)"
    " is not ported yet: ROADMAP.md queue 1, item 5; use the host path "
    "(use_shape_aug: True)")


def sym_canonical_rotation(rotation: np.ndarray) -> np.ndarray:
    """Map R to its canonical form about y for the symmetric categories."""
    theta_x = rotation[0, 0] + rotation[2, 2]
    theta_y = rotation[0, 2] - rotation[2, 0]
    r_norm = math.sqrt(theta_x ** 2 + theta_y ** 2)
    s_map = np.array([[theta_x / r_norm, 0.0, -theta_y / r_norm],
                      [0.0, 1.0, 0.0],
                      [theta_y / r_norm, 0.0, theta_x / r_norm]])
    return (rotation @ s_map).astype(np.float32)


def get_sym_info(cat_name: str, mug_handle: int = 1) -> np.ndarray:
    """FS-Net symmetry descriptor of a category."""
    table = {
        "bottle": [1, 1, 0, 1], "bowl": [1, 1, 0, 1], "camera": [0, 0, 0, 0],
        "can": [1, 1, 1, 1], "laptop": [0, 1, 0, 0],
    }
    if cat_name == "mug":
        return np.array([0, 1, 0, 0] if mug_handle == 1 else [1, 0, 0, 0], np.int32)
    return np.array(table.get(cat_name, [0, 0, 0, 0]), np.int32)


def update_choose_for_resize(choose: np.ndarray, crop_w: int, img_size: int) -> np.ndarray:
    """Remap flat crop indices to the resized crop."""
    ratio = img_size / crop_w
    col_idx = choose % crop_w
    row_idx = choose // crop_w
    return (np.floor(row_idx * ratio) * img_size + np.floor(col_idx * ratio)).astype(np.int64)


class TrainingDataset:
    """CAMERA (``data_type="syn"``) or Real (``"real_withLabel"``) training
    instances from a NOCS tree under ``data_dir``. ``num_img_per_epoch``
    sizes the epoch (``reset()`` resamples it; -1: every image once),
    ``per_obj`` keeps the images holding that category (cached in
    ``data_dir/img_list``), ``seed`` seeds the per-sample streams and the
    epoch resampling."""

    def __init__(self, config, data_dir: str, data_type: str = "real_withLabel",
                 num_img_per_epoch: int = -1, use_fill_miss: bool = True,
                 use_composed_img: bool = True, per_obj: str = "", seed: int | None = None,
                 device_preprocess: bool = False):
        if device_preprocess:
            raise NotImplementedError(DEVICE_PIPELINE_NOT_YET)
        self.config = config
        self.data_dir = data_dir
        self.data_type = data_type
        self.use_shape_aug = config.get("use_shape_aug", False)
        self.num_img_per_epoch = num_img_per_epoch
        self.use_fill_miss = use_fill_miss
        self.use_composed_img = use_composed_img
        self.img_size = config.img_size
        self.sample_num = config.sample_num
        self.base_seed = 0 if seed is None else int(seed)
        self.rng = np.random.RandomState(seed)  # epoch resampling only

        if data_type == "syn":
            img_path = "CAMERA/train_list.txt"
            model_path = "obj_models/camera_train.pkl"
            self.intrinsics = CAMERA_INTRINSICS
        elif data_type == "real_withLabel":
            img_path = "Real/train_list.txt"
            model_path = "obj_models/real_train.pkl"
            self.intrinsics = REAL_INTRINSICS
        else:
            raise ValueError(f"wrong data type {data_type}")

        with open(os.path.join(data_dir, img_path)) as f:
            img_list = [os.path.join(img_path.split("/")[0], line.rstrip("\n")) for line in f]

        self.cat_name2id = {n: i + 1 for i, n in enumerate(CAT_NAMES)}
        self.per_obj = per_obj
        self.per_obj_id = None
        if per_obj in CAT_NAMES:  # per-object filtering with cached lists
            self.per_obj_id = self.cat_name2id[per_obj]
            cache_dir = os.path.join(data_dir, "img_list")
            os.makedirs(cache_dir, exist_ok=True)
            cache = os.path.join(cache_dir, f"{per_obj}_{data_type}_img_list.txt")
            if os.path.exists(cache):
                with open(cache) as f:
                    img_list = [line.rstrip("\n") for line in f]
            else:
                kept = []
                for p in img_list:
                    try:
                        with open(os.path.join(data_dir, p + "_label.pkl"), "rb") as f:
                            gts = pickle.load(f)
                    except (OSError, pickle.UnpicklingError, EOFError):
                        continue  # an unreadable label drops its image
                    if self.per_obj_id in gts["class_ids"]:
                        kept.append(p)
                with open(cache, "w") as f:
                    f.writelines(p + "\n" for p in kept)
                img_list = kept

        self.img_list = img_list
        self.img_index = np.arange(len(img_list))

        with open(os.path.join(data_dir, model_path), "rb") as f:
            self.models = pickle.load(f)

        self.norm_scale = 1000.0

    def __len__(self) -> int:
        return (len(self.img_list) if self.num_img_per_epoch == -1
                else self.num_img_per_epoch)

    def reset(self) -> None:
        """Epoch resampling: ``num_img_per_epoch`` images drawn from the
        list (with replacement when the list is not longer)."""
        if self.num_img_per_epoch == -1:
            raise ValueError("reset() resamples a sized epoch; this dataset "
                             "has num_img_per_epoch = -1")
        num_img = len(self.img_list)
        self.img_index = self.rng.choice(num_img, self.num_img_per_epoch,
                                         replace=num_img <= self.num_img_per_epoch)

    def __getitem__(self, index: int) -> dict:
        """Sample ``index``; where its depth or its instance's pixels are
        missing, the sample at an index drawn from its stream (the JAX
        package's retry). An index already tried in the chain draws again:
        JAX recurses there into a cycle that never ends."""
        tried = set()
        while True:
            tried.add(index)
            # per-call RNG: deterministic per (seed, epoch resample, index)
            # and safe under threaded loaders (a shared one would race)
            rng = np.random.RandomState(
                (hash((self.base_seed, int(self.img_index[index]), index)) & 0x7FFFFFFF))
            out = self._sample(index, rng)
            if out is not None:
                return out
            if len(tried) >= len(self):
                raise RuntimeError(f"no usable sample in the epoch's "
                                   f"{len(self)} indices (depth or mask "
                                   f"missing in every one)")
            index = rng.randint(len(self))
            while index in tried:
                index = rng.randint(len(self))

    def _sample(self, index: int, rng: np.random.RandomState) -> dict | None:
        """One instance of the image at ``index``, or None where its depth
        or its instance's pixels are missing."""
        img_path = os.path.join(self.data_dir, self.img_list[self.img_index[index]])
        if self.data_type == "syn" and self.use_composed_img:
            depth = load_composed_depth(img_path)
        else:
            depth = load_depth(img_path)
        if depth is None:
            return None
        if self.use_fill_miss:
            depth = fill_missing(depth, self.norm_scale, 1)

        with open(img_path + "_label.pkl", "rb") as f:
            gts = pickle.load(f)
        num_instance = len(gts["instance_ids"])
        mask = cv2.imread(img_path + "_mask.png")[:, :, 2]

        if self.per_obj:
            idx = gts["class_ids"].index(self.per_obj_id)
        else:
            idx = rng.randint(0, num_instance)
        cat_id = gts["class_ids"][idx] - 1  # 0-indexed

        rmin, rmax, cmin, cmax = get_bbox(gts["bboxes"][idx])
        inst_mask = np.equal(mask, gts["instance_ids"][idx])
        inst_mask = np.logical_and(inst_mask, depth > 0)

        choose = inst_mask[rmin:rmax, cmin:cmax].flatten().nonzero()[0]
        if len(choose) <= 0:
            return None
        choose = choose[rng.choice(len(choose), self.sample_num,
                                   replace=len(choose) <= self.sample_num)]

        pts_map = backproject(depth, self.intrinsics, self.norm_scale)
        pts = pts_map[rmin:rmax, cmin:cmax].reshape(-1, 3)[choose].astype(np.float32)
        pts = pts + np.clip(0.001 * rng.randn(*pts.shape), -0.005, 0.005).astype(np.float32)

        rgb = cv2.imread(img_path + "_color.png")[:, :, :3][:, :, ::-1]
        rgb = rgb[rmin:rmax, cmin:cmax]
        rgb = cv2.resize(rgb, (self.img_size, self.img_size), interpolation=cv2.INTER_LINEAR)
        rgb = color_jitter(np.ascontiguousarray(rgb, np.uint8), rng)
        rgb = normalize_image(rgb)

        choose = update_choose_for_resize(choose, rmax - rmin, self.img_size)

        out = {
            "pts": pts,
            "rgb": rgb.astype(np.float32),
            "choose": choose.astype(np.int64),
            "category_label": np.int64(cat_id),
        }

        model = self.models[gts["model_list"][idx]].astype(np.float32)
        translation = gts["translations"][idx].astype(np.float32)
        rotation = gts["rotations"][idx].astype(np.float32)
        size = (gts["scales"][idx] * gts["sizes"][idx]).astype(np.float32)

        if cat_id in SYM_IDS:
            rotation = sym_canonical_rotation(rotation)
        qo = ((pts - translation[None]) / (np.linalg.norm(size) + 1e-8) @ rotation
              ).astype(np.float32)

        out.update(model=model, qo=qo, translation_label=translation,
                   rotation_label=rotation, size_label=size,
                   sym_info=get_sym_info(CAT_NAMES[cat_id], mug_handle=1))

        if self.use_shape_aug:
            bb_aug, rt_aug_t, rt_aug_r = generate_aug_parameters(rng)
            pc, r, t, s, model_new, nocs = data_augment(
                self.config, out["pts"], out["rotation_label"],
                out["translation_label"], out["size_label"], out["sym_info"],
                bb_aug, rt_aug_t, rt_aug_r, out["model"], gts["scales"][idx],
                out["qo"], cat_id, rng)
            out.update(pts=pc, rotation_label=r, translation_label=t,
                       size_label=s, model=model_new, qo=nocs)
        return out


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
