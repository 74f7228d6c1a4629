"""The port's train-side device pipeline against the JAX package's, on the
CPU: ColorJitter (``data/device_transforms.py``), the FS-Net box stretch
and rigid motion (``data/device_augment.py``) and the train side of
``data/device_preprocess.py``.

Both sides take the same draws: JAX's functions draw from their keys, and
the helpers here walk the same key tree (``split``; ``fold_in(key, 1)`` for
the jitter; ``split(k_pre, b)`` for the sampler's uniforms) and hand the
numbers to the port as tensors. Tolerances, float32 on both sides:
ColorJitter 2e-3 on the 0..255 scale (the HSV round trip divides by the
chroma, so an ulp of a near-gray pixel grows there; 2.5e-4 seen); the
augmentation 1e-5 of the largest value (sines, cosines and 3 x 3 products
rounded apart; 1.2e-7 seen); sampling indices, ``choose`` and ``n_valid``
equal; points 1e-6 m and ``qo`` 1e-5, also through the whole pipeline,
where each side fills the depth itself (7.7e-7 m and 6.4e-7 seen).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.data import device_augment as jda
from istnet_tpu.data import device_preprocess as jdp
from istnet_tpu.data import device_transforms as jdt
from istnet_tpu_torch import entry
from istnet_tpu_torch.data import depth_utils
from istnet_tpu_torch.data import device_augment as da
from istnet_tpu_torch.data import device_preprocess as dp
from istnet_tpu_torch.data import device_transforms as dt
from istnet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

JITTER = (0.2, 0.2, 0.2, 0.05)
CJ_ATOL = 2e-3          # ColorJitter, 0..255 scale
AUG_RTOL = 1e-5         # augmentation, of the largest value
PTS_ATOL = 1e-6         # metres, same completed depth
QO_ATOL = 1e-5


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def jax_color_draws(key, b: int, jitter=JITTER) -> dict:
    """The draws ``jdt.color_jitter_batch(rgb, key, *jitter)`` takes."""
    bri, con, sat, hue = jitter
    k_f, k_o = jax.random.split(key)
    kb, kc, ks, kh = jax.random.split(k_f, 4)
    factors = np.stack([
        jax.random.uniform(kb, (b,), minval=1 - bri, maxval=1 + bri),
        jax.random.uniform(kc, (b,), minval=1 - con, maxval=1 + con),
        jax.random.uniform(ks, (b,), minval=1 - sat, maxval=1 + sat)], 1)
    return {"factors": _t(factors),
            "hue": _t(jax.random.uniform(kh, (b,), minval=-hue, maxval=hue)),
            "order_id": _t(jax.random.randint(k_o, (b,), 0, 24)).long()}


def jax_instance_draws(key, b: int, sample_num: int) -> dict:
    """The uniforms and normals ``preprocess_train_instances_tpu`` draws
    from ``key``."""
    v = np.stack([np.array(jax.random.uniform(kk, (sample_num,)))
                  for kk in jax.random.split(key, b)])
    k_j, _ = jax.random.split(jax.random.fold_in(key, 1))
    return {"v": _t(v),
            "noise": _t(jax.random.normal(k_j, (b, sample_num, 3)))}


def jax_preprocess_draws(key, b: int, sample_num: int,
                         jitter=JITTER) -> dict:
    """The draws of ``jdp.make_train_preprocess(...)(raw, key)``."""
    k_pre, k_cj = jax.random.split(key)
    return {**jax_instance_draws(k_pre, b, sample_num),
            "color": jax_color_draws(k_cj, b, jitter)}


def jax_augment_draws(key, b: int, s_range=(0.8, 1.2), a_trans=50.0,
                      a_rot=15.0) -> dict:
    """The draws of ``jda.device_augment(batch, key, ...)``."""
    k_bbp, k_rtp, k_e, k_a, k_t = jax.random.split(key, 5)
    return {
        "ex": _t(jax.random.uniform(k_e, (b, 3), minval=s_range[0],
                                    maxval=s_range[1])),
        "u_bb": _t(jax.random.uniform(k_bbp, (b,))),
        "angles": _t(jax.random.uniform(k_a, (b, 3), minval=-a_rot,
                                        maxval=a_rot)),
        "aug_t": _t(jax.random.uniform(k_t, (b, 3), minval=-a_trans,
                                       maxval=a_trans) / 1000.0),
        "u_rt": _t(jax.random.uniform(k_rtp, (b,)))}


# ---------------------------------------------------------------------------
# ColorJitter
# ---------------------------------------------------------------------------

def _images(seed, b=24, size=48):
    return (np.random.RandomState(seed).rand(b, size, size, 3)
            * 255).astype(np.float32)


@pytest.mark.parametrize("orders", ["all_24", "drawn"])
def test_color_jitter_batch_matches_jax(monkeypatch, orders):
    """B=24 on 48 x 48: every order once (JAX's order draw forced to
    0..23), and JAX's own draws."""
    img = _images(1)
    key = jax.random.PRNGKey(11)
    draws = jax_color_draws(key, 24)
    if orders == "all_24":
        monkeypatch.setattr(jax.random, "randint",
                            lambda k, shape, lo, hi: jnp.arange(shape[0]))
        draws["order_id"] = torch.arange(24)
    else:
        assert len(set(draws["order_id"].tolist())) > 10
    want = np.asarray(jdt.color_jitter_batch(jnp.asarray(img), key, *JITTER))
    got = dt.color_jitter_batch(torch.from_numpy(img), draws).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CJ_ATOL)
    assert np.abs(got - img).max() > 1.0


def test_color_jitter_identity_factors_return_the_input():
    img = _images(2, b=24, size=16)
    draws = {"factors": torch.ones(24, 3), "hue": torch.zeros(24),
             "order_id": torch.arange(24)}
    got = dt.color_jitter_batch(torch.from_numpy(img), draws).numpy()
    np.testing.assert_allclose(got, img, rtol=0, atol=1e-3)
    ones = torch.ones(24, 1, 1, 1)
    for op in (dt.adjust_brightness, dt.adjust_contrast,
               dt.adjust_saturation):
        np.testing.assert_allclose(op(torch.from_numpy(img), ones).numpy(),
                                   img, rtol=0, atol=1e-3)


def test_color_jitter_composed_passes_equal_the_ops_in_order():
    """The two composed affine passes against the four ops applied one by
    one in each sample's order, on pixels in [40, 200], where no op
    saturates and so clipping after each op is inert (0.05 allowed)."""
    img = torch.from_numpy(40 + _images(3, b=24, size=16) * (160 / 255))
    draws = dt.draw_color_jitter(24, torch.Generator().manual_seed(5))
    draws["order_id"] = torch.arange(24)
    got = dt.color_jitter_batch(img, draws)
    f = draws["factors"]
    for i, order in enumerate(dt.ORDERS):
        x = img[i:i + 1]
        for op in order:
            if op == 3:
                x = dt.adjust_hue(x, draws["hue"][i])
            else:
                adjust = (dt.adjust_brightness, dt.adjust_contrast,
                          dt.adjust_saturation)[op]
                x = adjust(x, f[i, op])
        np.testing.assert_allclose(got[i].numpy(), x[0].numpy(), atol=0.05,
                                   err_msg=str(order))


@pytest.mark.parametrize("case", ["gray", "saturated", "black_white",
                                  "random"])
def test_hsv_round_trip_and_jax_hsv(case):
    pixels = {
        "gray": np.linspace(0, 1, 11)[:, None].repeat(3, 1),
        "saturated": np.array([[1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0],
                               [0, 1, 1], [1, 0, 1], [0.5, 0, 0.25]]),
        "black_white": np.array([[0, 0, 0], [1, 1, 1], [1, 0, 0], [0, 0, 1]]),
        "random": np.random.RandomState(4).rand(64, 3),
    }[case].astype(np.float32)
    hsv = dt._rgb_to_hsv(torch.from_numpy(pixels))
    np.testing.assert_allclose(hsv.numpy(),
                               np.asarray(jdt._rgb_to_hsv(jnp.asarray(pixels))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(dt._hsv_to_rgb(hsv).numpy(), pixels, rtol=0,
                               atol=1e-6)
    if case == "gray":
        assert (hsv[:, 1] == 0).all() and (hsv[:, 0] == 0).all()
    img = torch.from_numpy(pixels * 255)[None, None]
    np.testing.assert_allclose(dt.adjust_hue(img, torch.zeros(())).numpy(),
                               img.numpy(), rtol=0, atol=1e-3)


def test_draw_color_jitter_ranges():
    d = dt.draw_color_jitter(4096, torch.Generator().manual_seed(1))
    assert ((d["factors"] >= 0.8) & (d["factors"] <= 1.2)).all()
    assert ((d["hue"] >= -0.05) & (d["hue"] <= 0.05)).all()
    assert set(d["order_id"].tolist()) == set(range(24))


# ---------------------------------------------------------------------------
# FS-Net augmentation
# ---------------------------------------------------------------------------

def _aug_batch(seed, b=4, n=64, sym=0):
    rng = np.random.RandomState(seed)
    q = np.linalg.qr(rng.randn(b, 3, 3))[0].astype(np.float32)
    inputs = {"pts": (rng.randn(b, n, 3) * 0.1 + [0, 0, 0.8]).astype(np.float32),
              "qo": (rng.rand(b, n, 3) - 0.5).astype(np.float32),
              "sym_info": np.tile(np.array([sym, 1, 0, 1], np.int32), (b, 1))}
    labels = {"rotation_label": q,
              "translation_label": (rng.randn(b, 3) * 0.1).astype(np.float32),
              "size_label": (rng.rand(b, 3) * 0.2 + 0.05).astype(np.float32),
              "qo": inputs["qo"]}
    return {"inputs": inputs, "labels": labels}


@pytest.mark.parametrize("sym", [0, 1])
@pytest.mark.parametrize("gates", ["open", "shut", "config"])
def test_device_augment_matches_jax(sym, gates):
    pro = {"open": 1.0, "shut": 0.0, "config": 0.3}[gates]
    batch = _aug_batch(7 + sym, sym=sym)
    key = jax.random.PRNGKey(3)
    want = jda.device_augment(jax.tree_util.tree_map(jnp.asarray, batch), key,
                              aug_bb_pro=pro, aug_rt_pro=pro)
    got = da.device_augment(jax.tree_util.tree_map(torch.from_numpy, batch),
                            jax_augment_draws(key, 4), pro, pro)
    for part, name in (("inputs", "pts"), ("inputs", "qo"),
                       ("labels", "rotation_label"),
                       ("labels", "translation_label"),
                       ("labels", "size_label"), ("labels", "qo")):
        g, w = got[part][name].numpy(), np.asarray(want[part][name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=AUG_RTOL * np.abs(w).max(),
                                   err_msg=name)
        moved = not np.array_equal(g, batch[part][name])
        assert moved == (gates != "shut"), name


def test_euler_rotation_is_a_rotation_and_matches_jax():
    angles = np.random.RandomState(2).uniform(-15, 15, (16, 3)).astype(np.float32)
    got = da._euler_rotation(torch.from_numpy(angles)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jda._euler_rotation(jnp.asarray(angles))), atol=1e-6)
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape), atol=1e-6)


def test_make_device_augment_draws_from_the_generator():
    batch = jax.tree_util.tree_map(torch.from_numpy, _aug_batch(1))
    aug = da.make_device_augment(1.0, 1.0)
    a = aug(batch, torch.Generator().manual_seed(3))
    b = aug(batch, torch.Generator().manual_seed(3))
    c = aug(batch, torch.Generator().manual_seed(4))
    assert torch.equal(a["inputs"]["pts"], b["inputs"]["pts"])
    assert not torch.equal(a["inputs"]["pts"], c["inputs"]["pts"])
    d = da.draw_augment(4096, torch.Generator().manual_seed(0))
    assert ((d["ex"] >= 0.8) & (d["ex"] <= 1.2)).all()
    assert (d["angles"].abs() <= 15).all() and (d["aug_t"].abs() <= 0.05).all()


# ---------------------------------------------------------------------------
# Train-side preprocessing
# ---------------------------------------------------------------------------

def _train_frames(seed, b=3):
    """Full 480 x 640 raw frames (``entry.make_train_raw_batch``) with
    random rotations, translations and sizes."""
    raw = {k: v.numpy() for k, v in
           entry.make_train_raw_batch(b, seed=seed, device="cpu").items()}
    rng = np.random.RandomState(seed + 100)
    raw["rotation_label"] = np.linalg.qr(rng.randn(b, 3, 3))[0].astype(np.float32)
    raw["translation_label"] = (rng.randn(b, 3) * 0.1
                                + [0, 0, 0.9]).astype(np.float32)
    raw["category_label"] = rng.randint(0, 6, size=b).astype(np.int64)
    raw["sym_info"] = rng.randint(0, 2, size=(b, 4)).astype(np.int32)
    return raw


@pytest.mark.parametrize("normalize", [True, False])
def test_preprocess_train_instances_matches_jax(normalize):
    raw = _train_frames(3)
    depth = np.stack([depth_utils.fill_missing(d, 1000.0, 1)
                      for d in raw["depth_raw"]]).astype(np.float32)
    key = jax.random.PRNGKey(9)
    args = (raw["rgb_raw"], depth, raw["mask_raw"], raw["bbox"],
            raw["intrinsics"], raw["rotation_label"],
            raw["translation_label"], raw["size_label"])
    want = jdp.preprocess_train_instances_tpu(
        *map(jnp.asarray, args), key, img_size=48, sample_num=128,
        normalize=normalize)
    draws = jax_instance_draws(key, 3, 128)
    got = dp.preprocess_train_instances(
        *map(torch.from_numpy, args), img_size=48, sample_num=128,
        normalize=normalize, v=draws["v"], noise=draws["noise"])
    want = {k: np.asarray(v) for k, v in want.items()}
    np.testing.assert_array_equal(got["n_valid"].numpy(), want["n_valid"])
    assert (want["n_valid"] > 128).all()
    np.testing.assert_array_equal(got["choose"].numpy(), want["choose"])
    np.testing.assert_allclose(got["pts"].numpy(), want["pts"], rtol=0,
                               atol=PTS_ATOL)
    np.testing.assert_allclose(got["qo"].numpy(), want["qo"], rtol=0,
                               atol=QO_ATOL)
    rgb_atol = 2e-5 if normalize else 2e-3
    np.testing.assert_allclose(got["rgb"].numpy(), want["rgb"], rtol=0,
                               atol=rgb_atol)
    jitter = got["pts"].numpy() - dp.preprocess_instances(
        *map(torch.from_numpy, args[:5]), img_size=48, sample_num=128,
        v=draws["v"])["pts"].numpy()
    assert 0 < np.abs(jitter).max() <= dp.SHIFT_RANGE


def test_make_train_preprocess_matches_jax():
    """The whole pipeline on raw frames, each side filling the depth."""
    raw = _train_frames(5)
    key = jax.random.PRNGKey(2)
    want = jdp.make_train_preprocess(48, 128)(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    got = dp.make_train_preprocess(48, 128)(
        {k: torch.from_numpy(v) for k, v in raw.items()},
        jax_preprocess_draws(key, 3, 128))
    assert set(got) == set(want) == {"inputs", "labels"}
    for part in ("inputs", "labels"):
        assert set(got[part]) == set(want[part])
        for k, w in want[part].items():
            g, w = got[part][k].numpy(), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape, k
    gi = {k: v.numpy() for k, v in got["inputs"].items()}
    wi = {k: np.asarray(v) for k, v in want["inputs"].items()}
    np.testing.assert_array_equal(gi["choose"], wi["choose"])
    for k in ("category_label", "sym_info"):
        np.testing.assert_array_equal(gi[k], wi[k])
    np.testing.assert_allclose(gi["pts"], wi["pts"], rtol=0,
                               atol=PTS_ATOL)
    np.testing.assert_allclose(gi["qo"], wi["qo"], rtol=0, atol=QO_ATOL)
    to_255 = lambda x: (x * IMAGENET_STD + IMAGENET_MEAN) * 255  # noqa: E731
    np.testing.assert_allclose(to_255(gi["rgb"]), to_255(wi["rgb"]), rtol=0,
                               atol=CJ_ATOL)
    np.testing.assert_array_equal(got["labels"]["qo"].numpy(), gi["qo"])


def test_make_train_preprocess_draws_from_the_generator():
    raw = entry.make_train_raw_batch(2, seed=1, device="cpu")
    pre = dp.make_train_preprocess(48, 64, use_fill_miss=False)
    a = pre(raw, torch.Generator().manual_seed(0))
    b = pre(raw, torch.Generator().manual_seed(0))
    c = pre(raw, torch.Generator().manual_seed(1))
    for k in ("rgb", "pts", "choose"):
        assert torch.equal(a["inputs"][k], b["inputs"][k]), k
        assert not torch.equal(a["inputs"][k], c["inputs"][k]), k
    assert torch.isfinite(a["inputs"]["rgb"]).all()


def test_make_train_raw_batch_equals_the_jax_benches(monkeypatch):
    """Its arrays are ``tools/train_bench.py::make_synth_raw_batch``'s; it
    runs on the card unless asked for the CPU, and raises without one."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))
    from train_bench import make_synth_raw_batch

    want = make_synth_raw_batch(4, seed=3)
    got = entry.make_train_raw_batch(4, seed=3, device="cpu")
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError,
                       match="make_train_raw_batch: no CUDA card"):
        entry.make_train_raw_batch(1)
