"""The port's depth completion (kernel 11's plain version) against the JAX
package and the OpenCV pipeline, on the CPU.

Inputs come from a numpy seed. Tolerances: every maximum, minimum and median
of the chain is exact, so without the bilateral filter the port equals the
JAX XLA path bit for bit; with it the two differ by the rounding of ``exp``,
the 13 products and the divide (1e-5 m allowed, ~1e-6 seen). The
interpret-mode Pallas kernel is held to the same 1e-5 m. The OpenCV
pipeline is held to 1 mm, as ``tests/test_device_preprocess.py`` holds the
JAX path.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.data.device_preprocess import fill_in_multiscale_tpu
from istnet_tpu.ops.depth_fill_pallas import fill_in_multiscale_pallas
from istnet_tpu_torch import ops
from istnet_tpu_torch.data import depth_utils, device_preprocess
from istnet_tpu_torch.ops import depth_fill

ATOL_M = 1e-5


def _synthetic_depth(rng, b, h, w):
    d = rng.uniform(0.3, 2.8, size=(b, h, w)).astype(np.float32)
    d[rng.rand(b, h, w) < 0.35] = 0.0           # holes
    d[:, : h // 5] = 0.0                        # empty band at the top
    d[0, :, : w // 8] = 0.0                     # empty columns
    return d


def _port(depth):
    return ops.fill_in_multiscale(torch.from_numpy(depth)).numpy()


def _port_before_bilateral(depth):
    """The plain version's check-only argument: stop before the last filter."""
    return depth_fill.plain(torch.from_numpy(depth), 3.0,
                            bilateral=False).numpy()


@pytest.mark.parametrize("seed,shape", [(0, (2, 48, 128)), (1, (1, 40, 384)),
                                        (2, (2, 37, 150)), (3, (1, 5, 5))])
def test_plain_fill_matches_jax_xla_path(seed, shape):
    depth = _synthetic_depth(np.random.RandomState(seed), *shape)
    want = np.asarray(fill_in_multiscale_tpu(jnp.asarray(depth)))
    got = _port(depth)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_M)
    # the completed pixels are the same set
    np.testing.assert_array_equal(got > 0.01, want > 0.01)


@pytest.mark.parametrize("seed,shape", [(0, (2, 48, 128)), (1, (1, 40, 384))])
def test_plain_fill_matches_pallas_interpret(seed, shape):
    depth = _synthetic_depth(np.random.RandomState(seed), *shape)
    want = np.asarray(fill_in_multiscale_pallas(jnp.asarray(depth), 3.0, True))
    np.testing.assert_allclose(_port(depth), want, rtol=0, atol=ATOL_M)


def test_fill_without_bilateral_is_a_prefix_of_the_chain():
    """Without the last filter only masked pixels differ, and by little
    (the bilateral is a weighted mean of values the median smoothed)."""
    depth = _synthetic_depth(np.random.RandomState(4), 1, 60, 70)
    with_b, without = _port(depth), _port_before_bilateral(depth)
    np.testing.assert_array_equal(with_b > 0.01, without > 0.01)
    assert np.abs(with_b - without).max() < 1.5
    assert (with_b != without).any()


def test_fill_all_zero_frame_stays_zero():
    np.testing.assert_array_equal(_port(np.zeros((1, 32, 128), np.float32)),
                                  0.0)


def _frame_depth_mm(seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:480, 0:640]
    depth = 900.0 + 0.4 * xx + 0.7 * yy + 200.0 * np.sin(xx / 40.0)
    depth[rng.rand(480, 640) < 0.3] = 0.0
    depth[:80] = 0.0
    depth[:, 600:] = 0.0
    return depth.astype(np.float32)


def test_fill_matches_cv2_pipeline_sub_mm():
    depth_mm = _frame_depth_mm(5)
    want = depth_utils.fill_missing(depth_mm, 1000.0, 1.0)
    got = device_preprocess.fill_missing(
        torch.from_numpy(depth_mm)[None], 1000.0, 1.0)[0].numpy()
    assert np.abs(got - want).max() < 1.0   # millimetres
    # and without the bilateral the two pipelines agree to float rounding of
    # the unit scaling: OpenCV's morphology and median are exact too
    want_nb = depth_utils.fill_in_multiscale(depth_mm / 1000.0, 3.0,
                                             blur_type="none")
    got_nb = _port_before_bilateral(depth_mm[None] / 1000.0)[0]
    np.testing.assert_allclose(got_nb, want_nb, rtol=0, atol=1e-6)


def test_median5_matches_numpy_median():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 17, 23).astype(np.float32)
    x[rng.rand(*x.shape) < 0.3] = 0.0           # ties
    xp = np.pad(x, ((0, 0), (2, 2), (2, 2)), mode="edge")
    taps = np.stack([xp[:, 2 + dy:2 + dy + 17, 2 + dx:2 + dx + 23]
                     for dy in range(-2, 3) for dx in range(-2, 3)], -1)
    want = np.median(taps, axis=-1)
    got = depth_fill.median5(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def test_cuda_source_median_network_selects_the_median():
    """The compare-exchange list written into the CUDA source, run in
    numpy: five sorted quintuples in, rank 12 out at register 14."""
    src = (Path(__file__).resolve().parent.parent
           / depth_fill.SOURCE).read_text()
    body = src.split("MEDIAN25-BEGIN")[1].split("MEDIAN25-END")[0]
    ces = [(int(a), int(b))
           for a, b in re.findall(r"CE\((\d+), (\d+)\)", body)]
    assert len(ces) == 82
    rng = np.random.RandomState(7)
    v = rng.randint(0, 6, size=(20000, 25)).astype(np.float32)   # many ties
    v[:5000] = rng.randn(5000, 25)
    want = np.median(v, axis=1)
    v = np.sort(v.reshape(-1, 5, 5), axis=2).reshape(-1, 25)
    for a, b in ces:
        lo, hi = np.minimum(v[:, a], v[:, b]), np.maximum(v[:, a], v[:, b])
        v[:, a], v[:, b] = lo, hi
    np.testing.assert_array_equal(v[:, 14], want)


def test_bilateral_footprint_is_the_13_tap_disk():
    from istnet_tpu.data.device_preprocess import _footprint_offsets
    assert depth_fill.disk_offsets(2) == _footprint_offsets("disk", 2)
    assert len(depth_fill.disk_offsets(2)) == 13
