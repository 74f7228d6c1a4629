"""Offline dataset preparation: the port of
``istnet_tpu/cli/data_processing.py`` (the reference's
``data_processing.py``).

``python -m istnet_tpu_torch.cli.data_processing --data_dir data/NOCS
  [--skip_test_annotation] [--device cpu]``

Stages (the same outputs and formats as JAX's and the reference's, so that
data prepared by any of them interoperates):

- ``create_img_list``        (``data_processing.py:16-47``)
- ``process_data``           (``data_processing.py:66-158``): parse _meta.txt,
  masks, coord maps; filter bad renders and <64-point instances.
- ``annotate_camera_train``  (``data_processing.py:161-201``): Umeyama-RANSAC
  alignment of GT NOCS to depth, every hypothesis of an instance in one
  batched fit (``istnet_tpu_torch.ops.umeyama``) on ``device``: the card
  unless asked for the CPU.
- ``annotate_real_train``    (``data_processing.py:203-267``): cv2.solvePnP.
- ``annotate_test_data``     (``data_processing.py:270-384``): copies
  handle_visibility from the NOCS result pkls.
"""

from __future__ import annotations

import argparse
import glob
import os
import pickle

import cv2
import numpy as np

from istnet_tpu_torch.data.depth_utils import load_depth

CAMERA_K = np.array([[577.5, 0, 319.5], [0, 577.5, 239.5], [0, 0, 1]])
REAL_K = np.array([[591.0125, 0, 322.525], [0, 590.16775, 244.11084], [0, 0, 1]])
BAD_CAMERA_MUG = "b9be7cfe653740eb7633a2dd89cec754"


def create_img_list(data_dir: str) -> None:
    for subset in ["train", "val"]:
        img_dir = os.path.join(data_dir, "CAMERA", subset)
        folders = [n for n in os.listdir(img_dir)
                   if os.path.isdir(os.path.join(img_dir, n))]
        with open(os.path.join(data_dir, "CAMERA", subset + "_list_all.txt"), "w") as f:
            for i in range(10 * len(folders)):
                f.write(f"{subset}/{i // 10:05d}/{i % 10:04d}\n")
    for subset in ["train", "test"]:
        img_dir = os.path.join(data_dir, "Real", subset)
        folders = sorted(n for n in os.listdir(img_dir)
                         if os.path.isdir(os.path.join(img_dir, n)))
        with open(os.path.join(data_dir, "Real", subset + "_list_all.txt"), "w") as f:
            for folder in folders:
                for p in sorted(glob.glob(os.path.join(img_dir, folder, "*_color.png"))):
                    f.write(f"{subset}/{folder}/{os.path.basename(p).split('_')[0]}\n")
    print("Write all data paths to file done!")


def _all_exist(img_full_path: str) -> bool:
    return all(os.path.exists(img_full_path + s) for s in
               ("_color.png", "_coord.png", "_depth.png", "_mask.png", "_meta.txt"))


def process_data(img_path: str, depth, obj_model_dir: str, subset=None):
    """Parse one image's masks/coords/meta; None tuple when unusable."""
    mask = cv2.imread(img_path + "_mask.png")[:, :, 2].astype(np.int32)
    all_inst_ids = sorted(np.unique(mask).tolist())
    assert all_inst_ids[-1] == 255
    all_inst_ids = all_inst_ids[:-1]
    num_all = len(all_inst_ids)
    h, w = mask.shape

    coord_map = cv2.imread(img_path + "_coord.png")[:, :, :3][:, :, (2, 1, 0)]
    coord_map = coord_map.astype(np.float32) / 255
    coord_map[:, :, 2] = 1 - coord_map[:, :, 2]

    class_ids, instance_ids, model_list = [], [], []
    masks = np.zeros([h, w, num_all], np.uint8)
    coords = np.zeros((h, w, num_all, 3), np.float32)
    bboxes = np.zeros((num_all, 4), np.int32)
    scales = np.zeros([num_all, 3], np.float32)

    i = 0
    with open(img_path + "_meta.txt") as f:
        for line in f:
            info = line.strip().split(" ")
            inst_id, cls_id = int(info[0]), int(info[1])
            if cls_id == 0 or inst_id not in all_inst_ids:
                continue
            if len(info) == 3:  # Real scanned objects
                model_id = info[2]
                if model_id.endswith("npz"):
                    with np.load(os.path.join(obj_model_dir, "real_val", model_id)) as z:
                        scale = z["scale"]
                else:
                    scale = np.loadtxt(os.path.join(
                        obj_model_dir, "real_" + subset, model_id + ".txt"))
                scales[i] = scale / (np.linalg.norm(scale) + 1e-10)
            else:  # CAMERA objects
                model_id = info[3]
                bbox = np.loadtxt(os.path.join(obj_model_dir, subset, info[2], info[3],
                                               "bbox.txt"))
                scales[i] = bbox[0] - bbox[1]
            if model_id == BAD_CAMERA_MUG:
                continue
            inst_mask = np.equal(mask, inst_id)
            hor = np.where(np.any(inst_mask, axis=0))[0]
            ver = np.where(np.any(inst_mask, axis=1))[0]
            x1, x2 = hor[[0, -1]]
            y1, y2 = ver[[0, -1]]
            x2 += 1
            y2 += 1
            if (x2 - x1) > 600 or (y2 - y1) > 440:  # bad render
                return (None,) * 7
            if np.sum(np.logical_and(inst_mask, depth > 0)) < 64:
                continue
            class_ids.append(cls_id)
            instance_ids.append(inst_id)
            model_list.append(model_id)
            masks[:, :, i] = inst_mask
            coords[:, :, i, :] = coord_map * inst_mask[:, :, None]
            bboxes[i] = [y1, x1, y2, x2]
            i += 1
    if i == 0:
        return (None,) * 7
    return (masks[:, :, :i], np.clip(coords[:, :, :i], 0, 1), class_ids,
            instance_ids, model_list, bboxes[:i], scales[:i])


def align_nocs_to_depth(masks, coords, depth, intrinsics, instance_ids, img_path,
                        seed: int = 0, device="cuda"):
    """Per-instance Umeyama-RANSAC fit of GT NOCS to depth (align.py:124-156)
    on ``device``, instance ``i`` seeded ``seed + i``; identity pose on a
    degenerate fit, with its error message."""
    from istnet_tpu_torch.ops.umeyama import estimate_similarity_transform

    n = len(instance_ids)
    scales = np.zeros(n)
    rotations = np.zeros((n, 3, 3))
    translations = np.zeros((n, 3))
    error_messages = ""
    for i in range(n):
        mask = np.logical_and(masks[:, :, i], depth > 0)
        ys, xs = np.nonzero(mask)
        z = depth[ys, xs].astype(np.float64)
        fx, fy, cx, cy = intrinsics[0, 0], intrinsics[1, 1], intrinsics[0, 2], intrinsics[1, 2]
        pts = np.stack([(xs - cx) * z / fx, (ys - cy) * z / fy, z], axis=1)
        coord_pts = coords[ys, xs, i, :] - 0.5
        try:
            s, r, t, _ = estimate_similarity_transform(
                coord_pts, pts, seed=seed + i, device=device)
            if s is None:
                raise RuntimeError("degenerate RANSAC fit")
        except Exception as e:
            error_messages += (f"[ Error ] aligning instance {instance_ids[i]} in "
                               f"{img_path} fails. Message: {e}.\n")
            s, r, t = 1.0, np.eye(3), np.zeros(3)
        scales[i] = s / 1000.0
        rotations[i] = r
        translations[i] = t / 1000.0
    return scales, rotations, translations, error_messages


def annotate_camera_train(data_dir: str, device="cuda") -> None:
    from istnet_tpu_torch.entry import on_device
    # before the loop: a fit's failure only skips its image
    device = on_device(device, "annotate_camera_train")
    obj_model_dir = os.path.join(data_dir, "obj_models")
    img_list = open(os.path.join(data_dir, "CAMERA", "train_list_all.txt")).read().splitlines()
    valid = []
    for img_path in img_list:
        full = os.path.join(data_dir, "CAMERA", img_path)
        if not _all_exist(full):
            continue
        depth = load_depth(full)
        masks, coords, class_ids, instance_ids, model_list, bboxes, sizes = process_data(
            full, depth, obj_model_dir, subset="train")
        if instance_ids is None:
            continue
        scales, rotations, translations, errs = align_nocs_to_depth(
            masks, coords, depth, CAMERA_K, instance_ids, img_path,
            device=device)
        if errs:
            continue
        gts = {"class_ids": class_ids, "bboxes": bboxes,
               "scales": scales.astype(np.float32), "sizes": sizes.astype(np.float32),
               "rotations": rotations.astype(np.float32),
               "translations": translations.astype(np.float32),
               "instance_ids": instance_ids, "model_list": model_list}
        with open(full + "_label.pkl", "wb") as f:
            pickle.dump(gts, f)
        valid.append(img_path)
    with open(os.path.join(data_dir, "CAMERA/train_list.txt"), "w") as f:
        f.writelines(p + "\n" for p in valid)


def annotate_real_train(data_dir: str) -> None:
    obj_model_dir = os.path.join(data_dir, "obj_models")
    img_list = open(os.path.join(data_dir, "Real/train_list_all.txt")).read().splitlines()
    scale_factors = {}
    for p in sorted(glob.glob(os.path.join(obj_model_dir, "real_train", "*_norm.txt"))):
        scale_factors[os.path.basename(p).split(".")[0]] = np.linalg.norm(np.loadtxt(p))

    valid = []
    for img_path in img_list:
        full = os.path.join(data_dir, "Real", img_path)
        if not _all_exist(full):
            continue
        depth = load_depth(full)
        masks, coords, class_ids, instance_ids, model_list, bboxes, sizes = process_data(
            full, depth, obj_model_dir, subset="train")
        if instance_ids is None:
            continue
        n = len(class_ids)
        scales = np.zeros(n)
        rotations = np.zeros((n, 3, 3))
        translations = np.zeros((n, 3))
        for i in range(n):
            s = scale_factors[model_list[i]]
            ys, xs = np.where(masks[:, :, i])
            coord_pts = (s * (coords[ys, xs, i, :] - 0.5))[:, :, None]
            img_pts = np.stack([xs, ys], axis=1)[:, :, None].astype(float)
            ok, rvec, tvec = cv2.solvePnP(coord_pts, img_pts, REAL_K, np.zeros((4, 1)))
            assert ok
            rotations[i], _ = cv2.Rodrigues(rvec)
            translations[i] = np.squeeze(tvec)
            scales[i] = s
        gts = {"class_ids": class_ids, "bboxes": bboxes,
               "scales": scales.astype(np.float32), "sizes": sizes.astype(np.float32),
               "rotations": rotations.astype(np.float32),
               "translations": translations.astype(np.float32),
               "instance_ids": instance_ids, "model_list": model_list}
        with open(full + "_label.pkl", "wb") as f:
            pickle.dump(gts, f)
        valid.append(img_path)
    with open(os.path.join(data_dir, "Real/train_list.txt"), "w") as f:
        f.writelines(p + "\n" for p in valid)


def annotate_test_data(data_dir: str) -> None:
    """GT labels for CAMERA val / REAL test; copies handle_visibility from the
    NOCS result pkls (data_processing.py:270-384)."""
    obj_model_dir = os.path.join(data_dir, "obj_models")
    models = {}
    for path in ["obj_models/camera_val.pkl", "obj_models/real_test.pkl"]:
        with open(os.path.join(data_dir, path), "rb") as f:
            models.update(pickle.load(f))
    model_sizes = {k: 2 * np.amax(np.abs(v), axis=0) for k, v in models.items()}

    subsets = [
        ("Real", open(os.path.join(data_dir, "Real/test_list_all.txt")).read().splitlines(),
         REAL_K, "test"),
        ("CAMERA", open(os.path.join(data_dir, "CAMERA/val_list_all.txt")).read().splitlines(),
         CAMERA_K, "val"),
    ]
    for source, img_list, _, subset in subsets:
        valid = []
        for img_path in img_list:
            full = os.path.join(data_dir, source, img_path)
            if not _all_exist(full):
                continue
            depth = load_depth(full)
            masks, coords, class_ids, instance_ids, model_list, bboxes, sizes_unused = (
                process_data(full, depth, obj_model_dir, subset))
            if instance_ids is None:
                continue
            num = len(instance_ids)

            nocs_dir = os.path.join(data_dir, "results/nocs_results")
            scene, img_id = img_path.split("/")[-2], img_path.split("/")[-1]
            nocs_path = (os.path.join(nocs_dir, "val", f"results_val_{scene}_{img_id}.pkl")
                         if source == "CAMERA" else
                         os.path.join(nocs_dir, "real_test", f"results_test_{scene}_{img_id}.pkl"))
            with open(nocs_path, "rb") as f:
                nocs = pickle.load(f)

            map_to_nocs = []
            for i in range(num):
                gt_match = -1
                for j in range(len(nocs["gt_class_ids"])):
                    if nocs["gt_class_ids"][j] != class_ids[i]:
                        continue
                    if np.sum(np.abs(bboxes[i] - nocs["gt_bboxes"][j])) > 5:
                        continue
                    gt_match = j
                    break
                assert gt_match > -1, (img_path, instance_ids[i], "no match")
                assert gt_match not in map_to_nocs, (img_path, "duplicate match")
                map_to_nocs.append(gt_match)
            handle_visibility = np.asarray(nocs["gt_handle_visibility"])[map_to_nocs]

            sizes = np.zeros((num, 3))
            poses = np.zeros((num, 4, 4))
            scales = np.zeros(num)
            rotations = np.zeros((num, 3, 3))
            translations = np.zeros((num, 3))
            for i, gt_idx in enumerate(map_to_nocs):
                sizes[i] = model_sizes[model_list[i]]
                srt = np.asarray(nocs["gt_RTs"])[gt_idx]
                s = np.cbrt(np.linalg.det(srt[:3, :3]))
                scales[i] = s
                rotations[i] = srt[:3, :3] / s
                translations[i] = srt[:3, 3]
                pose = np.identity(4, np.float32)
                pose[:3, :3] = s * rotations[i]
                pose[:3, 3] = translations[i]
                poses[i] = pose
            gts = {"class_ids": np.array(class_ids), "bboxes": bboxes,
                   "instance_ids": instance_ids, "model_list": model_list,
                   "sizes": sizes, "scales": scales.astype(np.float32),
                   "rotations": rotations.astype(np.float32),
                   "translations": translations.astype(np.float32),
                   "poses": poses.astype(np.float32),
                   "handle_visibility": handle_visibility}
            with open(full + "_label.pkl", "wb") as f:
                pickle.dump(gts, f)
            valid.append(img_path)
        with open(os.path.join(data_dir, source, subset + "_list.txt"), "w") as f:
            f.writelines(p + "\n" for p in valid)


def main(argv=None):
    p = argparse.ArgumentParser(description="NOCS dataset preparation")
    p.add_argument("--data_dir", default="data/NOCS")
    p.add_argument("--skip_test_annotation", action="store_true",
                   help="reference default: test annotation disabled "
                        "(data_processing.py:395)")
    p.add_argument("--device", default="cuda",
                   help="where the RANSAC runs: 'cuda' (default) or 'cpu'")
    args = p.parse_args(argv)
    create_img_list(args.data_dir)
    annotate_camera_train(args.data_dir, args.device)
    annotate_real_train(args.data_dir)
    if not args.skip_test_annotation:
        annotate_test_data(args.data_dir)


if __name__ == "__main__":
    main()
