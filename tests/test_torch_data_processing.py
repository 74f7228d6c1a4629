"""The port's NOCS data preparation (``cli/data_processing.py``, its raw tree
``data/synthetic.py::build_raw_prep_tree``) against the JAX package's.

The port's raw tree equals JAX's file by file. Two copies of it are
annotated, one by each package's four stages, and every artifact compared
as ``tests/test_data_processing.py`` compares JAX's with the reference's,
JAX's implementation being the reference here:

- the image lists, as text;
- Real-train labels: ``cv2.solvePnP`` sees the same float64 inputs, equal;
- CAMERA-train labels: both RANSACs (the port's draws from a torch
  generator, JAX's from its key) converge to the all-inlier refit of the
  geometrically consistent tree, float32 on both sides: within 1e-5;
- test labels (a copy of the handle visibility and the sRT
  decomposition): equal to float64 round-off.

The labels then feed the port's ``TrainingDataset``.
"""

import filecmp
import os
import pickle
import shutil

import numpy as np
import pytest

from istnet_tpu_torch.cli import data_processing as dp
from istnet_tpu_torch.data import synthetic

LISTS = ("CAMERA/train_list_all.txt", "CAMERA/val_list_all.txt",
         "Real/train_list_all.txt", "Real/test_list_all.txt",
         "CAMERA/train_list.txt", "Real/train_list.txt",
         "CAMERA/val_list.txt", "Real/test_list.txt")
RANSAC_TOL = 1e-5


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    from istnet_tpu.data.synthetic import build_raw_prep_tree

    base = tmp_path_factory.mktemp("prep")
    synthetic.build_raw_prep_tree(str(base / "port"))
    build_raw_prep_tree(str(base / "jax"))
    return base


def test_raw_tree_equals_jax_file_by_file(trees):
    port, jax_root = str(trees / "port"), str(trees / "jax")
    names = _files(port)
    assert names == _files(jax_root) and len(names) > 40
    for rel in names:
        a, b = os.path.join(port, rel), os.path.join(jax_root, rel)
        if rel.endswith(".npz"):      # a zip stamps its time of writing
            with np.load(a) as za, np.load(b) as zb:
                assert set(za) == set(zb)
                for k in zb:
                    np.testing.assert_array_equal(za[k], zb[k], err_msg=rel)
        else:
            assert filecmp.cmp(a, b, shallow=False), rel


@pytest.fixture(scope="module")
def annotated(trees):
    from istnet_tpu.cli import data_processing as jax_dp

    ours, theirs = str(trees / "ours"), str(trees / "theirs")
    shutil.copytree(trees / "port", ours)
    shutil.copytree(trees / "port", theirs)
    jax_dp.create_img_list(theirs)
    jax_dp.annotate_camera_train(theirs)
    jax_dp.annotate_real_train(theirs)
    jax_dp.annotate_test_data(theirs)
    dp.main(["--data_dir", ours, "--device", "cpu"])
    return ours, theirs


def _read(path):
    with open(path) as f:
        return f.read()


def _load_pkl(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_img_lists_equal_jax(annotated):
    ours, theirs = annotated
    for rel in LISTS:
        assert _read(os.path.join(ours, rel)) == _read(
            os.path.join(theirs, rel)), rel
    kept = _read(os.path.join(ours, "CAMERA/train_list.txt")).split()
    assert kept == ["train/00000/0000", "train/00000/0002"]


def _compare_label(ours_path, theirs_path, ransac=False):
    a, b = _load_pkl(ours_path), _load_pkl(theirs_path)
    assert set(a) == set(b), set(a) ^ set(b)
    for key, bv in b.items():
        av = a[key]
        assert type(av) is type(bv), key
        if not isinstance(bv, np.ndarray):
            assert av == bv, key
            continue
        assert av.dtype == bv.dtype and av.shape == bv.shape, key
        if ransac and key in ("scales", "rotations", "translations"):
            np.testing.assert_allclose(av, bv, rtol=RANSAC_TOL,
                                       atol=RANSAC_TOL, err_msg=key)
        else:
            np.testing.assert_array_equal(av, bv, err_msg=key)


def test_camera_train_labels_within_float32(annotated):
    ours, theirs = annotated
    for stem in ("0000", "0002"):
        rel = f"CAMERA/train/00000/{stem}_label.pkl"
        _compare_label(os.path.join(ours, rel), os.path.join(theirs, rel),
                       ransac=True)
    gts = _load_pkl(os.path.join(ours, "CAMERA/train/00000/0000_label.pkl"))
    assert gts["instance_ids"] == [1, 2] and gts["class_ids"] == [1, 2]
    for r in gts["rotations"]:
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-4)
        assert np.linalg.det(r) > 0.9


def test_real_train_and_test_labels_equal_jax(annotated):
    ours, theirs = annotated
    for rel in ("Real/train/scene_1/0000_label.pkl",
                "Real/train/scene_1/0001_label.pkl",
                "Real/test/scene_1/0000_label.pkl",
                "CAMERA/val/00000/0000_label.pkl"):
        _compare_label(os.path.join(ours, rel), os.path.join(theirs, rel))
    gts = _load_pkl(os.path.join(ours, "Real/test/scene_1/0000_label.pkl"))
    np.testing.assert_array_equal(gts["handle_visibility"], [0, 1])


def test_labels_feed_the_training_dataset(annotated):
    from istnet_tpu_torch.data.dataset import TrainingDataset
    from istnet_tpu_torch.utils import Config

    ours, _ = annotated
    cfg = Config({"img_size": 48, "sample_num": 64, "shift_range": 0.01,
                  "use_shape_aug": False})
    ds = TrainingDataset(cfg, ours, data_type="real_withLabel",
                         num_img_per_epoch=-1, use_fill_miss=False,
                         use_composed_img=False, seed=0)
    sample = ds[0]
    assert sample["pts"].shape == (64, 3)
    assert sample["rgb"].shape[-3:] == (48, 48, 3)
    assert np.isfinite(sample["qo"]).all()


def test_the_ransac_runs_on_the_card_unless_asked(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dp.annotate_camera_train(str(tmp_path))
