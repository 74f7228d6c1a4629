"""The port's host C++ depth fill (``istnet_tpu_torch/native``) and the
routing of ``data/depth_utils.fill_missing``, against the JAX package's.

- The port's core gives JAX's core (``istnet_tpu/native``) bit for bit on
  the band depth of ``tests/test_native_core.py``, a 480 x 640 frame with
  40% holes and far-depth outliers (skipped where either core cannot be
  built), and stays within 0.01 mm of the port's OpenCV chain there.
- ``fill_missing``'s default is the core; ``prefer_native=False`` and
  ``ISTNET_NATIVE_DEPTH_FILL=0`` give the OpenCV chain, and so do the
  non-default configurations and frames under 5 x 5, as in JAX.
- A compiler that is missing or fails raises with its log: no fallback.
- ``fill_in_fast`` / ``fill_type="fast"`` equal JAX's (both OpenCV).
- A ``TrainingDataset`` and a ``TestDataset`` sample on both packages'
  defaults (both native) are bit-equal.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from istnet_tpu import native as jax_native
from istnet_tpu.data import dataset as jax_dataset
from istnet_tpu.data import depth_utils as jax_depth_utils
from istnet_tpu.data import synthetic as jax_synthetic
from istnet_tpu.utils.config import Config as JaxConfig
from istnet_tpu_torch import native
from istnet_tpu_torch.data import dataset, depth_utils, synthetic
from istnet_tpu_torch.utils import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CV2_TOL_MM = 0.01          # tests/test_native_core.py's bound


def _band_depth():
    rng = np.random.RandomState(0)
    depth = (1500 + 300 * rng.rand(96, 128)).astype(np.float32)
    depth[:, 64:] = 2200 + 500 * rng.rand(96, 64)
    depth[48:, :32] = 600 + 300 * rng.rand(48, 32)
    depth[rng.rand(96, 128) < 0.3] = 0
    depth[:12] = 0
    return depth


def _frame_depth():
    rng = np.random.RandomState(1)
    yy, xx = np.mgrid[:480, :640].astype(np.float32)
    depth = 900.0 + 0.6 * yy + 400.0 * np.sin(xx / 50.0) + 50 * rng.rand(480, 640)
    depth[rng.rand(480, 640) < 0.4] = 0
    depth[:60] = 0
    return depth.astype(np.float32)


def _far_depth():
    rng = np.random.RandomState(0)
    d = (1500 + 900 * rng.rand(120, 160)).astype(np.float32)
    d[rng.rand(120, 160) < 0.3] = 0
    d[:20] = 12000.0
    d[40:44, 60:70] = 50000.0
    return d


DEPTHS = {"band": _band_depth, "frame_480x640": _frame_depth,
          "far_outliers": _far_depth}


@pytest.fixture(scope="module")
def both_cores():
    if not (native.available() and jax_native.available()):
        pytest.skip("a native core cannot be built on this host")


@pytest.mark.parametrize("name", list(DEPTHS))
def test_core_equals_the_jax_core(both_cores, name):
    depth = DEPTHS[name]()
    got = native.fill_missing_native(depth.copy(), 1000.0, 1)
    want = jax_native.fill_missing_native(depth.copy(), 1000.0, 1)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        native.fill_in_multiscale_native(depth / 1000.0),
        jax_native.fill_in_multiscale_native(depth / 1000.0))


@pytest.mark.parametrize("name", list(DEPTHS))
def test_core_within_a_hundredth_mm_of_opencv(name):
    depth = DEPTHS[name]()
    got = native.fill_missing_native(depth.copy(), 1000.0, 1)
    want = depth_utils.fill_missing(depth.copy(), 1000.0, 1,
                                    prefer_native=False)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got > 0, want > 0)
    assert float(np.abs(got - want).max()) < CV2_TOL_MM


def test_default_fill_missing_is_the_core(monkeypatch):
    depth = _band_depth()
    direct = native.fill_missing_native(depth.copy(), 1000.0, 1)
    np.testing.assert_array_equal(
        depth_utils.fill_missing(depth.copy(), 1000.0, 1), direct)
    np.testing.assert_array_equal(
        depth_utils.fill_missing(depth.copy(), 1000.0, 1, prefer_native=True),
        direct)
    calls = []
    monkeypatch.setattr(native, "fill_missing_native",
                        lambda *a: calls.append(a) or direct)
    depth_utils.fill_missing(depth.copy(), 1000.0, 1)
    assert len(calls) == 1


def _no_core(monkeypatch):
    def refuse(*a):
        raise AssertionError("the native core was called")
    monkeypatch.setattr(native, "fill_missing_native", refuse)


def test_prefer_native_false_and_the_flag_give_opencv(monkeypatch):
    depth = _band_depth()
    opencv = depth_utils.fill_missing(depth.copy(), 1000.0, 1,
                                      prefer_native=False)
    want = depth_utils.fill_in_multiscale(depth / 1000.0, 3.0) * 1000.0
    np.testing.assert_array_equal(opencv, want)
    _no_core(monkeypatch)
    np.testing.assert_array_equal(
        depth_utils.fill_missing(depth.copy(), 1000.0, 1,
                                 prefer_native=False), opencv)
    monkeypatch.setattr(depth_utils, "_NATIVE_OK", False)
    np.testing.assert_array_equal(
        depth_utils.fill_missing(depth.copy(), 1000.0, 1), opencv)


def test_environment_variable_asks_for_opencv(tmp_path):
    """``ISTNET_NATIVE_DEPTH_FILL=0`` read at import, as in JAX."""
    depth = _band_depth()
    np.save(tmp_path / "d.npy", depth)
    code = (
        "import sys, numpy as np\n"
        "from istnet_tpu_torch import native\n"
        "from istnet_tpu_torch.data import depth_utils as du\n"
        "def refuse(*a): raise AssertionError('native core called')\n"
        "native.fill_missing_native = refuse\n"
        "assert du._NATIVE_OK is False\n"
        "d = np.load(sys.argv[1])\n"
        "np.save(sys.argv[2], du.fill_missing(d, 1000.0, 1))\n")
    env = {**os.environ, "ISTNET_NATIVE_DEPTH_FILL": "0",
           "PYTHONPATH": REPO}
    subprocess.run([sys.executable, "-c", code, str(tmp_path / "d.npy"),
                    str(tmp_path / "o.npy")], env=env, check=True,
                   timeout=300)
    np.testing.assert_array_equal(
        np.load(tmp_path / "o.npy"),
        depth_utils.fill_missing(depth, 1000.0, 1, prefer_native=False))


@pytest.mark.parametrize("blur_type,fill_type", [
    ("bilateral", "fast"), ("gaussian", "fast"), ("gaussian", "multiscale")])
def test_non_default_configs_take_opencv(monkeypatch, blur_type, fill_type):
    depth = _band_depth()
    want = jax_depth_utils.fill_missing(depth.copy(), 1000.0, 1, blur_type,
                                        fill_type, prefer_native=False)
    _no_core(monkeypatch)
    got = depth_utils.fill_missing(depth.copy(), 1000.0, 1, blur_type,
                                   fill_type)
    np.testing.assert_array_equal(got, want)


def test_tiny_frames_take_opencv_and_the_core_stays_in_bounds(monkeypatch):
    rng = np.random.RandomState(3)
    frames = [(800 + 2000 * rng.rand(h, w)).astype(np.float32)
              for h, w in [(1, 1), (1, 7), (2, 2), (4, 9), (3, 3)]]
    for d in frames:
        assert np.isfinite(native.fill_missing_native(d.copy(), 1000.0,
                                                      1)).all()
    _no_core(monkeypatch)
    for d in frames:
        np.testing.assert_array_equal(
            depth_utils.fill_missing(d.copy(), 1000.0, 1),
            depth_utils.fill_missing(d.copy(), 1000.0, 1,
                                     prefer_native=False))


@pytest.mark.parametrize("extrapolate", [False, True])
@pytest.mark.parametrize("blur_type", ["bilateral", "gaussian"])
def test_fill_in_fast_equals_jax(blur_type, extrapolate):
    depth = _band_depth() / 1000.0
    np.testing.assert_array_equal(
        depth_utils.fill_in_fast(depth, extrapolate=extrapolate,
                                 blur_type=blur_type),
        jax_depth_utils.fill_in_fast(depth, extrapolate=extrapolate,
                                     blur_type=blur_type))


def _fake_compiler(tmp_path, log):
    cc = tmp_path / "cc"
    cc.write_text("#!/bin/sh\n"
                  "if [ \"$1\" = \"--version\" ]; then echo fake-cc 1.0; "
                  "exit 0; fi\n"
                  f"echo '{log}' >&2\nexit 1\n")
    cc.chmod(0o755)
    return str(cc)


@pytest.mark.parametrize("case", ["missing", "failing"])
def test_a_core_that_cannot_build_raises(tmp_path, monkeypatch, case):
    """No silent fallback: the default path raises with the compiler's
    log, and leaves no library behind."""
    if case == "missing":
        cxx, match = str(tmp_path / "no" / "such" / "g++"), "not found"
    else:
        cxx = _fake_compiler(tmp_path, "depth_fill.cpp:1: error: broken")
        match = "error: broken"
    monkeypatch.setenv("CXX", cxx)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match=match):
        depth_utils.fill_missing(_band_depth(), 1000.0, 1)
    assert not native.available()
    assert not list((tmp_path / "build").rglob("*.so"))


def test_a_build_lands_under_its_hash(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD", tmp_path / "build")
    lib = native.build()
    assert lib.parent.parent == tmp_path / "build"
    assert lib.name == native.LIB_NAME and lib.is_file()
    assert native.build() == lib                   # cached
    assert sorted(p.name for p in lib.parent.iterdir()) == [native.LIB_NAME]


IMG, NPTS = 48, 128
AUG = {"aug_bb_pro": 0.3, "aug_rt_pro": 0.3, "aug_bc_pro": 0.0,
       "aug_pc_pro": 0.0, "aug_pc_r": 0.002, "aug_nl_pro": 0.0}


def _assert_samples_equal(got: dict, want: dict, where: str = ""):
    assert set(got) == set(want), where
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_samples_equal(got[k], w, f"{where}{k}/")
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype, where + k
        np.testing.assert_array_equal(g, w, err_msg=where + k)


@pytest.mark.parametrize("data_type", ["syn", "real_withLabel"])
def test_training_samples_on_both_defaults_are_equal(both_cores, tmp_path,
                                                     data_type):
    port, ref = str(tmp_path / "port" / "data"), str(tmp_path / "jax" / "data")
    synthetic.build_train_trees(port, n_scenes=2)
    jax_synthetic.build_train_trees(ref, n_scenes=2)
    assert depth_utils._NATIVE_OK and jax_depth_utils._NATIVE_OK
    cfg = {"img_size": IMG, "sample_num": NPTS, "use_shape_aug": True, **AUG}
    kw = dict(data_type=data_type, num_img_per_epoch=2, seed=5)
    got_ds = dataset.TrainingDataset(Config(cfg), port, **kw)
    want_ds = jax_dataset.TrainingDataset(JaxConfig(cfg), ref, **kw)
    got_ds.reset()
    want_ds.reset()
    for i in range(len(got_ds)):
        _assert_samples_equal(got_ds[i], want_ds[i])


def test_test_samples_on_both_defaults_are_equal(both_cores, tmp_path):
    synthetic.build_test_tree(str(tmp_path), n_scenes=2, n_inst=3)
    cfg = {"img_size": IMG, "sample_num": NPTS}
    got = dataset.TestDataset(Config(cfg), str(tmp_path))
    want = jax_dataset.TestDataset(JaxConfig(cfg), str(tmp_path))
    assert len(got) == len(want) == 2
    for i in range(len(got)):
        _assert_samples_equal(got[i], want[i])
