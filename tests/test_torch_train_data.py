"""The port's training data path against the JAX package's, bit for bit.

Every function on both sides is numpy (no jit): the synthetic train trees,
``TrainingDataset`` samples (CAMERA and Real, the FS-Net augmentation on,
a ``per_obj`` case), ``DataLoader`` batches over two resampled epochs, the
PIL colour jitter and each augmentation on fixed draws. Then the loader's
own contracts (a failing sample raises in the consumer, the producer stops
with the consumer) and the Solver's epoch contract.

Both packages fill depth through their native C++ cores by default (bit
for bit alike, ``tests/test_torch_native.py``, which also holds samples on
both defaults); here both sides run their OpenCV chains, so that the
comparison does not hang on either core building.
"""

import filecmp
import os
import threading

import numpy as np
import pytest
import torch

from istnet_tpu.data import augment as jax_augment
from istnet_tpu.data import dataset as jax_dataset
from istnet_tpu.data import depth_utils as jax_depth_utils
from istnet_tpu.data import loader as jax_loader
from istnet_tpu.data import synthetic as jax_synthetic
from istnet_tpu.data import transforms as jax_transforms
from istnet_tpu.utils.config import Config as JaxConfig
from istnet_tpu_torch.data import augment, dataset, loader, synthetic, transforms
from istnet_tpu_torch.data import depth_utils as port_depth_utils
from istnet_tpu_torch.utils import Config

IMG, NPTS = 48, 128
AUG = {"aug_bb_pro": 0.3, "aug_rt_pro": 0.3, "aug_bc_pro": 0.0,
       "aug_pc_pro": 0.0, "aug_pc_r": 0.002, "aug_nl_pro": 0.0}
# every augmentation at p = 1: the synthetic scenes hold a bottle and a
# bowl, so the box-cage taper (bowl) and the non-linear resize run too
AUG_ALL = {"aug_bb_pro": 1.0, "aug_rt_pro": 1.0, "aug_bc_pro": 1.0,
           "aug_pc_pro": 1.0, "aug_pc_r": 0.002, "aug_nl_pro": 1.0}


@pytest.fixture(autouse=True)
def _opencv_fill(monkeypatch):
    monkeypatch.setattr(jax_depth_utils, "_NATIVE_OK", False)
    monkeypatch.setattr(port_depth_utils, "_NATIVE_OK", False)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The port's tree and the JAX package's, each under a ``/data/`` dir
    (the composed-depth path needs it); the per_obj cache lands in each."""
    root = tmp_path_factory.mktemp("train_trees")
    port, ref = str(root / "port" / "data"), str(root / "jax" / "data")
    synthetic.build_train_trees(port, n_scenes=3)
    jax_synthetic.build_train_trees(ref, n_scenes=3)
    return port, ref


def _cfg(aug, cls):
    return cls({"img_size": IMG, "sample_num": NPTS, "use_shape_aug": True,
                **aug})


def _assert_samples_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        w = np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_build_train_trees_writes_the_jax_packages_files(trees):
    port, ref = trees
    names = []
    for dirpath, _, files in os.walk(ref):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ref)
            names.append(rel)
    assert len(names) > 20
    match, mismatch, errors = filecmp.cmpfiles(ref, port, names, shallow=False)
    assert not mismatch and not errors


@pytest.mark.parametrize("data_type", ["syn", "real_withLabel"])
@pytest.mark.parametrize("aug", [AUG, AUG_ALL], ids=["config", "all_augs"])
def test_training_samples_equal_the_jax_packages(trees, data_type, aug):
    port, ref = trees
    kw = dict(data_type=data_type, num_img_per_epoch=6, seed=5)
    got_ds = dataset.TrainingDataset(_cfg(aug, Config), port, **kw)
    want_ds = jax_dataset.TrainingDataset(_cfg(aug, JaxConfig), ref, **kw)
    got_ds.reset()
    want_ds.reset()
    np.testing.assert_array_equal(got_ds.img_index, want_ds.img_index)
    for i in range(len(got_ds)):
        _assert_samples_equal(got_ds[i], want_ds[i])
    sample = got_ds[0]
    assert sample["pts"].shape == (NPTS, 3)
    assert sample["rgb"].shape == (IMG, IMG, 3)
    assert sample["choose"].max() < IMG * IMG


def test_per_obj_samples_and_cached_lists_equal_the_jax_packages(trees):
    port, ref = trees
    kw = dict(data_type="real_withLabel", per_obj="bowl", seed=2)
    for _ in range(2):        # the second pass reads the cached lists
        got_ds = dataset.TrainingDataset(_cfg(AUG, Config), port, **kw)
        want_ds = jax_dataset.TrainingDataset(_cfg(AUG, JaxConfig), ref, **kw)
        assert got_ds.img_list == want_ds.img_list and len(got_ds) == 3
        for i in range(len(got_ds)):
            s = got_ds[i]
            _assert_samples_equal(s, want_ds[i])
            assert s["category_label"] == 1               # bowl
    assert filecmp.cmp(os.path.join(port, "img_list",
                                    "bowl_real_withLabel_img_list.txt"),
                       os.path.join(ref, "img_list",
                                    "bowl_real_withLabel_img_list.txt"),
                       shallow=False)


def test_a_missing_depth_retries_at_a_random_index(trees):
    """A CAMERA frame without its composed depth takes the sample at an
    index drawn from its stream. Where the JAX package's retry chain ends,
    the port's sample equals it; where JAX's chain comes back to an index
    it tried, JAX recurses until Python's limit stops it, and the port
    draws again and returns a sample of a frame that is there. Seed 1's
    epoch has both kinds of chain."""
    port, ref = trees
    kw = dict(data_type="syn", num_img_per_epoch=6, seed=1,
              use_composed_img=True)
    got_ds = dataset.TrainingDataset(_cfg(AUG, Config), port, **kw)
    want_ds = jax_dataset.TrainingDataset(_cfg(AUG, JaxConfig), ref, **kw)
    for ds in (got_ds, want_ds):
        ds.reset()
        ds.img_list = [p.replace("0001", "9999") for p in ds.img_list]
    kinds = set()
    for i in range(len(got_ds)):
        got = got_ds[i]
        missing = "9999" in got_ds.img_list[got_ds.img_index[i]]
        try:
            want = want_ds[i]
        except RecursionError:
            kinds.add("cycle")
            assert missing and np.isfinite(got["pts"]).all()
            continue
        _assert_samples_equal(got, want)
        if missing:
            kinds.add("retried")
    assert kinds == {"cycle", "retried"}
    got_ds.img_list = [p.replace("0000", "9999").replace("0002", "9999")
                       for p in got_ds.img_list]
    with pytest.raises(RuntimeError, match="no usable sample"):
        got_ds[0]


def test_device_preprocess_is_refused_with_its_roadmap_item(trees):
    """Raw frames leave no host points to augment: ``device_preprocess``
    with ``use_shape_aug`` is refused with the JAX package's ValueError
    (``use_device_aug`` augments on the device instead)."""
    for ds in (dataset, jax_dataset):
        with pytest.raises(ValueError, match="set use_device_aug instead"):
            ds.TrainingDataset(_cfg(AUG, Config), trees[0],
                               device_preprocess=True)


@pytest.mark.parametrize("data_type", ["syn", "real_withLabel"])
def test_raw_samples_equal_the_jax_packages_over_two_epochs(trees, data_type,
                                                           monkeypatch):
    """``device_preprocess=True``: the raw frame of each sample (no host
    fill) equal to JAX's, keys, dtypes and values, over two resampled
    epochs; a frame whose instance mask is empty retries as JAX does."""
    port, ref = trees
    cfg = {"img_size": IMG, "sample_num": NPTS, "use_shape_aug": False,
           "use_device_aug": True, **AUG}
    kw = dict(data_type=data_type, num_img_per_epoch=5, seed=3,
              device_preprocess=True)
    got_ds = dataset.TrainingDataset(Config(cfg), port, **kw)
    want_ds = jax_dataset.TrainingDataset(JaxConfig(cfg), ref, **kw)
    for _ in range(2):
        got_ds.reset()
        want_ds.reset()
        np.testing.assert_array_equal(got_ds.img_index, want_ds.img_index)
        for i in range(len(got_ds)):
            _assert_samples_equal(got_ds[i], want_ds[i])
    s = got_ds[0]
    assert s["depth_raw"].shape == s["mask_raw"].shape == (480, 640)
    assert s["rgb_raw"].dtype == np.uint8 and s["mask_raw"].any()
    assert (s["depth_raw"] == 0).any()       # raw: the holes stay
    # a frame whose mask holds no pixel of its instance retries at an index
    # drawn from the sample's stream, on both sides
    import cv2
    blank = got_ds.img_list[got_ds.img_index[0]] + "_mask.png"
    real_imread, blanked = cv2.imread, []

    def imread(path, *args):
        img = real_imread(path, *args)
        if path.endswith(blank):
            blanked.append(path)
            return np.zeros_like(img)
        return img
    monkeypatch.setattr(cv2, "imread", imread)
    _assert_samples_equal(got_ds[0], want_ds[0])
    assert len(blanked) >= 2


def test_loader_batches_equal_the_jax_packages_over_two_epochs(trees):
    port, ref = trees
    kw = dict(data_type="syn", num_img_per_epoch=6, seed=1)
    got_ds = dataset.TrainingDataset(_cfg(AUG, Config), port, **kw)
    want_ds = jax_dataset.TrainingDataset(_cfg(AUG, JaxConfig), ref, **kw)
    got_dl = loader.DataLoader(got_ds, 2, num_workers=3)
    want_dl = jax_loader.DataLoader(want_ds, 2, num_workers=1)
    for _ in range(2):
        got_ds.reset()
        want_ds.reset()
        got, want = list(got_dl), list(want_dl)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            _assert_samples_equal(g, w)
            assert g["pts"].shape == (2, NPTS, 3)


def test_collate_equals_the_jax_packages():
    samples = [{"a": np.arange(3) + i, "b": np.float32(i), "c": {"gt": i}}
               for i in range(2)]
    got, want = loader.collate(samples), jax_loader.collate(samples)
    assert got["c"] == want["c"] == [{"gt": 0}, {"gt": 1}]
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


class _Flaky:
    """A dataset whose sample 3 raises."""

    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 3:
            raise OSError("broken sample 3")
        return {"x": np.full(2, i)}


def test_loader_raises_a_failed_sample_in_the_consumer():
    dl = loader.DataLoader(_Flaky(), 2, shuffle=False, num_workers=2)
    it = iter(dl)
    assert next(it)["x"].tolist() == [[0, 0], [1, 1]]
    with pytest.raises(OSError, match="broken sample 3"):
        next(it)


def test_loader_producer_stops_with_the_consumer():
    class Counting(_Flaky):
        def __init__(self):
            self.calls = 0

        def __getitem__(self, i):
            self.calls += 1
            return {"x": np.full(2, i)}

        def __len__(self):
            return 400

    ds = Counting()
    before = threading.active_count()
    dl = loader.DataLoader(ds, 2, num_workers=2, prefetch=2)
    it = iter(dl)
    next(it)
    it.close()
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before
    assert ds.calls < 400


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_color_jitter_equals_the_jax_packages(seed):
    img = (np.random.RandomState(100 + seed).rand(40, 48, 3) * 255).astype(np.uint8)
    got = transforms.color_jitter(img, np.random.RandomState(seed))
    want = jax_transforms.color_jitter(img, np.random.RandomState(seed))
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)
    np.testing.assert_array_equal(transforms.normalize_image(img),
                                  jax_transforms.normalize_image(img))
    np.testing.assert_array_equal(transforms.IMAGENET_MEAN,
                                  jax_transforms.IMAGENET_MEAN)
    np.testing.assert_array_equal(transforms.IMAGENET_STD,
                                  jax_transforms.IMAGENET_STD)


def _cloud(seed):
    rng = np.random.RandomState(seed)
    r = jax_augment.get_rotation(10.0, -20.0, 35.0)
    t = np.array([0.05, -0.02, 0.8], np.float32)
    s = np.array([0.1, 0.2, 0.12], np.float32)
    pts = (rng.randn(64, 3) * 0.05).astype(np.float32) @ r.T + t
    nocs = (rng.rand(64, 3) - 0.5).astype(np.float32)
    model = (rng.rand(40, 3) - 0.5).astype(np.float32)
    return pts, r, t, s, nocs, model


def _equal_tuples(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert np.asarray(g).dtype == np.asarray(w).dtype


@pytest.mark.parametrize("name", [
    "get_rotation", "generate_aug_parameters", "defor_3d_bb",
    "defor_3d_bb_sym", "defor_3d_rt", "defor_3d_bc", "defor_3d_pc",
    "deform_non_linear_x", "deform_non_linear_y", "data_augment"])
def test_each_augmentation_equals_the_jax_packages(name):
    pts, r, t, s, nocs, model = _cloud(4)
    bb, rt_t, rt_r = jax_augment.generate_aug_parameters(np.random.RandomState(8))
    cfg = dict(AUG_ALL)
    calls = {
        "get_rotation": lambda m, rng: m.get_rotation(12.0, -7.5, 33.0),
        "generate_aug_parameters": lambda m, rng: m.generate_aug_parameters(rng),
        "defor_3d_bb": lambda m, rng: m.defor_3d_bb(
            pts, r, t, s, nocs, model, np.array([0, 1, 0, 0]), bb),
        "defor_3d_bb_sym": lambda m, rng: m.defor_3d_bb(
            pts, r, t, s, nocs, model, np.array([1, 1, 0, 1]), bb),
        "defor_3d_rt": lambda m, rng: m.defor_3d_rt(pts, r, t, rt_t, rt_r),
        "defor_3d_bc": lambda m, rng: m.defor_3d_bc(
            pts.copy(), r, t, s, model, nocs, rng),
        "defor_3d_pc": lambda m, rng: m.defor_3d_pc(pts, 0.002, rng),
        "deform_non_linear_x": lambda m, rng: m.deform_non_linear(
            pts.copy(), r, t, s, nocs, model, 0, rng),
        "deform_non_linear_y": lambda m, rng: m.deform_non_linear(
            pts.copy(), r, t, s, nocs, model, 1, rng),
        "data_augment": lambda m, rng: m.data_augment(
            cfg, pts.copy(), r, t, s, np.array([1, 1, 0, 1]), bb, rt_t, rt_r,
            model, 1.0, nocs, 1, rng),
    }
    got = calls[name](augment, np.random.RandomState(21))
    want = calls[name](jax_augment, np.random.RandomState(21))
    _equal_tuples(got, want)


def test_sym_helpers_equal_the_jax_packages():
    r = jax_augment.get_rotation(20.0, 40.0, -10.0)
    np.testing.assert_array_equal(dataset.sym_canonical_rotation(r),
                                  jax_dataset.sym_canonical_rotation(r))
    for name in dataset.CAT_NAMES + ["other"]:
        for handle in (0, 1):
            np.testing.assert_array_equal(
                dataset.get_sym_info(name, handle),
                jax_dataset.get_sym_info(name, handle))


def test_solver_refuses_a_loader_shorter_than_the_epoch_contract(trees):
    from istnet_tpu_torch.train.solver import Solver
    from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer

    ds = dataset.TrainingDataset(_cfg(AUG, Config), trees[0],
                                 data_type="syn", num_img_per_epoch=4, seed=0)
    model = torch.nn.Linear(2, 2)
    cfg = TrainConfig()
    solver = Solver(model, make_optimizer(model, cfg), cfg,
                    Config({"max_epoch": 1, "num_mini_batch_per_epoch": 3}),
                    syn_loader=loader.DataLoader(ds, 2))
    with pytest.raises(ValueError, match="epoch contract is 3 iterations"):
        solver.train_epoch(1)
