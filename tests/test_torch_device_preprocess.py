"""The port's device preprocessing (test side) against the JAX package and
the host pipeline, on the CPU.

Inputs come from a numpy seed; the sampler's uniforms are JAX's own (one
``jax.random.uniform`` per split key), fed to both sides, so indices,
``choose`` and ``n_valid`` must be EQUAL. Tolerances: back-projection and
the gathered points repeat JAX's float32 operations (1e-6 m allowed for a
differently fused multiply-divide); the two-tap resize sums the two
non-zero terms of JAX's 440-term contraction (2e-5 of the normalised value
allowed, 2e-2 of a 0..255 level against ``cv2.resize`` on float input,
which derives its weights from the scale in another precision: 7.5e-3 seen
at 440 -> 48).
"""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.data import device_preprocess as jdp
from istnet_tpu_torch import entry
from istnet_tpu_torch.data import depth_utils
from istnet_tpu_torch.data import device_preprocess as dp
from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
from istnet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD


def _jax_uniforms(key, k, sample_num):
    """The ``v`` that ``preprocess_*_tpu`` draws for its K instances."""
    return np.stack([np.array(jax.random.uniform(kk, (sample_num,)))
                     for kk in jax.random.split(key, k)])


def test_square_crop_bounds_matches_get_bbox():
    rng = np.random.RandomState(0)
    y1 = rng.randint(0, 400, 200)
    x1 = rng.randint(0, 560, 200)
    boxes = np.stack([y1, x1, y1 + rng.randint(1, 480, 200).clip(max=479 - y1)
                      + 1, x1 + rng.randint(1, 640, 200).clip(max=639 - x1)
                      + 1], 1).astype(np.int32)
    got = dp.square_crop_bounds(torch.from_numpy(boxes)).numpy()
    want = np.asarray([depth_utils.get_bbox(b) for b in boxes])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jdp.square_crop_bounds(jnp.asarray(boxes))))


@pytest.mark.parametrize("per_sample", [False, True])
def test_backproject_batch_matches_jax_and_numpy(per_sample):
    rng = np.random.RandomState(1)
    depth = rng.uniform(300, 2500, (2, 30, 40)).astype(np.float32)
    intr = np.asarray(REAL_INTRINSICS, np.float32)
    if per_sample:
        intr = np.stack([intr, intr * 1.1])
    got = dp.backproject_batch(torch.from_numpy(depth),
                               torch.from_numpy(intr)).numpy()
    want = np.asarray(jdp.backproject_batch(jnp.asarray(depth),
                                            jnp.asarray(intr)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if not per_sample:
        np.testing.assert_allclose(
            got[0], depth_utils.backproject(depth[0], REAL_INTRINSICS),
            rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cw", [40, 120, 192, 440])
def test_resize_matches_cv2_and_jax(cw):
    rng = np.random.RandomState(2)
    frame = (rng.rand(480, 640, 3) * 255).astype(np.uint8)
    rmin, cmin = 480 - cw, 640 - cw - 3 if cw < 440 else 100
    got = dp._resize_half_pixel(
        torch.from_numpy(frame)[None], torch.zeros(1, dtype=torch.long),
        torch.tensor([rmin]), torch.tensor([cmin]), torch.tensor([cw]),
        48)[0].numpy()
    crop = frame[rmin:rmin + cw, cmin:cmin + cw]
    want_cv = cv2.resize(crop.astype(np.float32), (48, 48),
                         interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(got, want_cv, rtol=0, atol=2e-2)
    padded = np.zeros((440, 440, 3), np.float32)
    padded[:cw, :cw] = crop
    want_jax = np.asarray(jdp._resize_half_pixel(
        jnp.asarray(padded), jnp.asarray(cw, jnp.int32), 48))
    np.testing.assert_allclose(got, want_jax, rtol=0, atol=2e-3)


def _jax_sample(ok, v):
    """The JAX module's sampler on one row (``_instance_body``'s lines)."""
    intra, block_end = jdp._blocked_cdf(jnp.asarray(ok))
    count = block_end[-1].astype(jnp.int32)
    s = v.shape[0]
    slot = jnp.arange(s, dtype=jnp.float32)
    u = (slot + jnp.asarray(v)) / s * count.astype(jnp.float32)
    targets = jnp.floor(u).astype(jnp.int32) + 1
    flat = jdp._searchsorted_blocked(
        intra, block_end, jnp.minimum(targets, jnp.maximum(count, 1)),
        n=ok.shape[0])
    return np.asarray(flat), int(count)


@pytest.mark.parametrize("n_valid", [0, 1, 9, 16, 100, 128, 5000])
def test_sampler_indices_equal_jax(n_valid):
    rng = np.random.RandomState(3 + n_valid)
    n, s = 440 * 440, 128
    ok = np.zeros(n, bool)
    ok[rng.choice(n, n_valid, replace=False)] = True
    v = np.array(jax.random.uniform(jax.random.PRNGKey(n_valid), (s,)))
    want, want_count = _jax_sample(ok, v)
    got, count = dp.sample_valid_cells(torch.from_numpy(ok)[None],
                                       torch.from_numpy(v)[None])
    got = got[0].numpy()
    assert int(count[0]) == want_count == n_valid
    if n_valid == 0:
        # JAX returns n, one past the end, and its gather clamps; the port
        # clamps the index itself
        assert (want == n).all() and (got == n - 1).all()
        return
    np.testing.assert_array_equal(got, want)
    assert ok[got].all()
    if n_valid <= s // 2:  # strata no wider than half a cell: all, repeated
        assert set(got) == set(np.flatnonzero(ok))
    elif n_valid >= s:     # one per stratum: no duplicates
        assert len(set(got)) == s


def _frame(seed, k, n_tiny=0):
    fr = entry.make_frame(seed, k, n_tiny=n_tiny)
    depth = depth_utils.fill_missing(fr["depth_raw"], 1000.0, 1.0)
    return fr, depth.astype(np.float32)


@pytest.fixture(scope="module")
def shared_image():
    fr, depth = _frame(4, 5, n_tiny=1)
    masks = np.concatenate([fr["masks"], np.zeros((1, 480, 640), bool)])
    bboxes = np.concatenate([fr["bboxes"], fr["bboxes"][-1:]])
    key = jax.random.PRNGKey(7)
    v = _jax_uniforms(key, 6, 128)
    intr = np.asarray(REAL_INTRINSICS, np.float32)
    want = jdp.preprocess_shared_image_tpu(
        jnp.asarray(fr["rgb_full"]), jnp.asarray(depth), jnp.asarray(masks),
        jnp.asarray(bboxes), jnp.asarray(intr), key, img_size=48,
        sample_num=128)
    got = dp.preprocess_shared_image(
        torch.from_numpy(fr["rgb_full"]), torch.from_numpy(depth),
        torch.from_numpy(masks), torch.from_numpy(bboxes),
        torch.from_numpy(intr), img_size=48, sample_num=128,
        v=torch.from_numpy(v))
    return ({k: t.numpy() for k, t in got.items()},
            {k: np.asarray(a) for k, a in want.items()}, fr, depth, masks)


def test_shared_image_counts_and_choose_equal_jax(shared_image):
    got, want, *_ = shared_image
    np.testing.assert_array_equal(got["n_valid"], want["n_valid"])
    assert list(got["n_valid"][-2:]) == [9, 0]
    # rows with at least one valid pixel, the 9-pixel one included
    np.testing.assert_array_equal(got["choose"][:5], want["choose"][:5])
    assert got["choose"].dtype == np.int32
    # the empty row is clamped into range where JAX's gather would clamp
    assert 0 <= got["choose"].min() and got["choose"].max() < 48 * 48
    assert got["flat_idx"].max() < 440 * 440


def test_shared_image_points_and_rgb_match_jax(shared_image):
    got, want, *_ = shared_image
    np.testing.assert_allclose(got["pts"][:5], want["pts"][:5], rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got["rgb"], want["rgb"], rtol=0, atol=2e-5)
    assert np.isfinite(got["pts"]).all() and np.isfinite(got["rgb"]).all()


def test_shared_image_points_lie_in_their_masks(shared_image):
    """Against the host pipeline: each sampled point is the back-projected
    pixel of its instance's crop, inside the mask."""
    got, _, fr, depth, masks = shared_image
    pts_map = depth_utils.backproject(depth, REAL_INTRINSICS)
    for j in range(5):
        rmin, rmax, cmin, cmax = depth_utils.get_bbox(fr["bboxes"][j])
        rows = rmin + got["flat_idx"][j] // 440
        cols = cmin + got["flat_idx"][j] % 440
        assert (rows < rmax).all() and (cols < cmax).all()
        assert masks[j][rows, cols].all()
        np.testing.assert_allclose(got["pts"][j], pts_map[rows, cols],
                                   rtol=1e-5, atol=1e-7)
        crop = cv2.resize(
            np.ascontiguousarray(fr["rgb_full"][rmin:rmax, cmin:cmax]),
            (48, 48), interpolation=cv2.INTER_LINEAR)
        want_rgb = (crop.astype(np.float32) / 255.0 - IMAGENET_MEAN) \
            / IMAGENET_STD
        # cv2 resizes uint8 with 11-bit fixed-point weights and rounds the
        # result to a level: within one level of 255
        assert np.abs(got["rgb"][j] - want_rgb).max() < 1.0 / 255 / 0.224


def test_preprocess_instances_matches_shared_image_rows(shared_image):
    """One image per instance gives the rows of the shared-image call."""
    got, _, fr, depth, masks = shared_image
    k = masks.shape[0]
    v = _jax_uniforms(jax.random.PRNGKey(7), k, 128)
    bboxes = np.concatenate([fr["bboxes"], fr["bboxes"][-1:]])
    out = dp.preprocess_instances(
        torch.from_numpy(fr["rgb_full"])[None].expand(k, -1, -1, -1),
        torch.from_numpy(depth)[None].expand(k, -1, -1),
        torch.from_numpy(masks), torch.from_numpy(bboxes),
        torch.tensor(REAL_INTRINSICS), img_size=48, sample_num=128,
        v=torch.from_numpy(v))
    for name in ("rgb", "pts", "choose", "n_valid"):
        np.testing.assert_array_equal(out[name].numpy(), got[name])


def test_generator_draws_are_reproducible():
    fr, depth = _frame(5, 2)
    args = (torch.from_numpy(fr["rgb_full"]), torch.from_numpy(depth),
            torch.from_numpy(fr["masks"]), torch.from_numpy(fr["bboxes"]),
            torch.tensor(REAL_INTRINSICS))
    a = dp.preprocess_shared_image(
        *args, torch.Generator().manual_seed(3), img_size=48, sample_num=64)
    b = dp.preprocess_shared_image(
        *args, torch.Generator().manual_seed(3), img_size=48, sample_num=64)
    c = dp.preprocess_shared_image(
        *args, torch.Generator().manual_seed(4), img_size=48, sample_num=64)
    assert torch.equal(a["choose"], b["choose"])
    assert not torch.equal(a["choose"], c["choose"])
