"""The port's batched Umeyama fit and RANSAC (``ops/umeyama.py``) against
``istnet_tpu/ops/umeyama.py``, the cases of ``tests/test_umeyama.py``.

The two frameworks' generators draw different hypotheses, so the RANSAC's
scoring is compared on JAX's own draws
(``jax.random.randint(PRNGKey(seed), (128, 5), 0, n)``) fed to
``score_hypotheses``: the same ratios (of every hypothesis that fixes a
rotation) and inlier mask, and the refit within 1e-5 relative. The port's
own draws are held to the truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.ops import umeyama as J
from istnet_tpu_torch.ops import umeyama as T

FIT_RTOL = 1e-5


def _random_similarity(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    r = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])
    return r, rng.uniform(0.5, 2.0), rng.randn(3)


def _outlier_pair(seed, n=200, n_out=40):
    rng = np.random.RandomState(seed)
    r, s, t = _random_similarity(rng)
    src = rng.randn(n, 3) * 0.3
    tgt = src @ (s * r).T + t
    out_idx = rng.choice(n, n_out, replace=False)
    tgt[out_idx] += rng.randn(n_out, 3) * 3.0
    return src, tgt, (s, r, t)


def _close(got, want, rtol=FIT_RTOL):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= rtol * max(1.0, np.abs(want).max()), err


def test_umeyama_exact_recovery_and_equal_to_jax():
    rng = np.random.RandomState(0)
    r, s, t = _random_similarity(rng)
    src = rng.randn(50, 3)
    tgt = src @ (s * r).T + t
    got = T.umeyama(torch.from_numpy(src), torch.from_numpy(tgt))
    want = J.umeyama(jnp.asarray(src), jnp.asarray(tgt))
    np.testing.assert_allclose(float(got[0]), s, rtol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), r, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), t, atol=1e-5)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def test_umeyama_weighted_equals_subset():
    rng = np.random.RandomState(1)
    r, s, t = _random_similarity(rng)
    src = rng.randn(40, 3)
    tgt = src @ (s * r).T + t
    tgt[30:] += rng.randn(10, 3) * 5
    w = np.zeros(40)
    w[:30] = 1.0
    weighted = T.umeyama(torch.from_numpy(src), torch.from_numpy(tgt),
                         torch.from_numpy(w))
    subset = T.umeyama(torch.from_numpy(src[:30]), torch.from_numpy(tgt[:30]))
    jax_weighted = J.umeyama(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(w))
    np.testing.assert_allclose(float(weighted[0]), float(subset[0]), rtol=1e-6)
    np.testing.assert_allclose(weighted[1].numpy(), subset[1].numpy(),
                               atol=1e-6)
    for g, want in zip(weighted, jax_weighted):
        _close(g.numpy(), want)


def _jax_scores(src, tgt, idx):
    """JAX's per-hypothesis ratios and inlier masks
    (``istnet_tpu/ops/umeyama.py:85-97``), from JAX's ``umeyama``."""
    source, target = jnp.asarray(src, jnp.float32), jnp.asarray(tgt, jnp.float32)
    diameter = 2.0 * jnp.max(jnp.linalg.norm(
        source - jnp.mean(source, axis=0), axis=-1))

    def hypothesis(sub_idx):
        s, r, t, _ = J.umeyama(source[sub_idx], target[sub_idx])
        resid = jnp.linalg.norm(target - (source @ (s * r).T + t), axis=-1)
        inlier = resid < s * diameter / 10.0
        return jnp.mean(inlier.astype(jnp.float32)), inlier

    ratios, inliers = jax.vmap(hypothesis)(jnp.asarray(idx))
    return np.asarray(ratios), np.asarray(inliers)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_hypotheses_on_jax_draws_equals_jax(seed):
    src, tgt, _ = _outlier_pair(seed)
    key = jax.random.PRNGKey(seed)
    idx = np.asarray(jax.random.randint(key, (128, 5), 0, len(src)))
    want = J.ransac_similarity(jnp.asarray(src), jnp.asarray(tgt), key)
    ratios, inliers = _jax_scores(src, tgt, idx)
    got = T.score_hypotheses(torch.from_numpy(src), torch.from_numpy(tgt),
                             torch.from_numpy(idx))
    # a hypothesis of fewer than 3 distinct points fixes no rotation: the
    # two SVDs may pick different ones (seed 0, hypothesis 103)
    fixed = np.array([len(set(h)) >= 3 for h in idx])
    assert fixed.sum() >= 120
    np.testing.assert_array_equal(got["ratios"].numpy()[fixed], ratios[fixed])
    best = int(np.argmax(ratios))
    np.testing.assert_array_equal(got["inlier_mask"].numpy(),
                                  inliers[best].astype(np.float32))
    assert float(got["inlier_ratio"]) == float(want["inlier_ratio"])
    assert bool(got["valid"]) == bool(want["valid"])
    for k in ("scale", "rotation", "translation", "transform"):
        _close(got[k].numpy(), want[k])


def test_ransac_rejects_outliers():
    src, tgt, (s, r, t) = _outlier_pair(2)
    res = T.ransac_similarity(torch.from_numpy(src), torch.from_numpy(tgt),
                              torch.Generator().manual_seed(0))
    assert bool(res["valid"])
    np.testing.assert_allclose(float(res["scale"]), s, rtol=1e-2)
    np.testing.assert_allclose(res["rotation"].numpy(), r, atol=1e-2)
    np.testing.assert_allclose(res["translation"].numpy(), t, atol=1e-2)
    # the port's draws and JAX's reach the same all-inlier refit
    want = J.ransac_similarity(jnp.asarray(src), jnp.asarray(tgt),
                               jax.random.PRNGKey(0))
    np.testing.assert_array_equal(float(res["inlier_ratio"]),
                                  float(want["inlier_ratio"]))
    _close(res["rotation"].numpy(), want["rotation"])


def test_batched_over_instances():
    """A batch of 4 clouds in one call equals each cloud alone, and JAX's
    ``vmap`` of its RANSAC on the same draws."""
    rng = np.random.RandomState(4)
    srcs, tgts = [], []
    for _ in range(4):
        r, s, t = _random_similarity(rng)
        src = rng.randn(100, 3)
        srcs.append(src)
        tgts.append(src @ (s * r).T + t)
    src, tgt = np.stack(srcs), np.stack(tgts)
    keys = jax.random.split(jax.random.PRNGKey(1), 4)
    idx = np.stack([np.asarray(jax.random.randint(k, (128, 5), 0, 100))
                    for k in keys])
    want = jax.vmap(lambda s_, t_, k: J.ransac_similarity(s_, t_, k))(
        jnp.asarray(src), jnp.asarray(tgt), keys)
    got = T.score_hypotheses(torch.from_numpy(src), torch.from_numpy(tgt),
                             torch.from_numpy(idx))
    assert got["rotation"].shape == (4, 3, 3) and bool(got["valid"].all())
    for k in ("scale", "rotation", "translation", "transform"):
        _close(got[k].numpy(), want[k])
    for i in range(4):
        alone = T.score_hypotheses(torch.from_numpy(src[i]),
                                   torch.from_numpy(tgt[i]),
                                   torch.from_numpy(idx[i]))
        for k in ("scale", "rotation", "translation"):
            _close(got[k][i].numpy(), alone[k].numpy(), 1e-6)
    drawn = T.ransac_similarity(torch.from_numpy(src), torch.from_numpy(tgt),
                                torch.Generator().manual_seed(1))
    assert drawn["ratios"].shape == (4, 128) and bool(drawn["valid"].all())


def test_wrapper_api_and_the_none_return():
    rng = np.random.RandomState(3)
    r, s, t = _random_similarity(rng)
    src = rng.randn(60, 3)
    tgt = src @ (s * r).T + t
    es, er, et, etf = T.estimate_similarity_transform(src, tgt, device="cpu")
    assert isinstance(es, float) and er.shape == (3, 3) and et.shape == (3,)
    np.testing.assert_allclose(etf[:3, :3], es * er, rtol=1e-4)
    np.testing.assert_allclose(es, s, rtol=1e-5)
    # a target collapsed to a point: scale 0, no inlier, as JAX says
    flat = np.zeros_like(src)
    assert J.estimate_similarity_transform(src, flat) == (None,) * 4
    assert T.estimate_similarity_transform(src, flat, device="cpu") == (
        None,) * 4


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_runs_on_the_card_unless_asked():
    with pytest.raises(RuntimeError, match="no CUDA card"):
        T.estimate_similarity_transform(np.zeros((8, 3)), np.zeros((8, 3)))
