"""The port's layers and sub-networks against their flax counterparts.

Weights start as the port's random init (BN statistics and PReLU slopes
perturbed, so that mean 0 / var 1 cannot hide a swap), go to flax trees
through the JAX package's numpy converter, get nonzero SharedMLP dense
biases there (which the bridge must fold into the BN means), and come back
through ``state_dict_from_jax`` into a fresh port model loaded strictly.
Each module then runs on the same numpy-seeded inputs in both frameworks,
float32 on the CPU. Tolerance 1e-4 absolute (unless stated): the two
frameworks sum convolutions and matmuls in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.entry import build_model
from istnet_tpu_torch.models.ist_net import CAM_RADII, ISTNet, gather_by_choose
from istnet_tpu_torch.nn import layers
from istnet_tpu_torch.nn.rotation import ortho6d_to_mat

torch.set_num_threads(1)

TINY = (32, 16, 8, 8)
ATOL = 1e-4


def _set_dense_biases(tree, rng, inside=False):
    """Nonzero SharedMLP dense biases (the port's convs have none)."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if inside and k == "Dense_0":
            v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
        else:
            _set_dense_biases(v, rng, inside or k.startswith("SharedMLP"))


def _jax_variables(seed: int = 3):
    src = build_model(sa_npoints=TINY, seed=seed)
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(seed))
    return trees


@pytest.fixture(scope="module")
def models():
    trees = _jax_variables()
    port = ISTNet(sa_npoints=TINY)
    port.load_state_dict(state_dict_from_jax(trees), strict=True)
    return port.eval(), trees


def _sub(trees, name):
    out = {"params": trees["params"][name]}
    if name in trees["batch_stats"]:
        out["batch_stats"] = trees["batch_stats"][name]
    return out


def _close(got: torch.Tensor, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_dense_biases_were_nonzero(models):
    _, trees = models
    b = trees["params"]["pts_cam_extractor"]["PointnetSAModuleMSG_1"][
        "SharedMLP_0"]["TorchDense_0"]["Dense_0"]["bias"]
    assert np.abs(b).max() > 0


def test_sparse_points_matches_flax(models):
    from istnet_tpu.nn.resnet_psp import ModifiedResnet

    port, trees = models
    rng = np.random.RandomState(1)
    img = 48
    rgb = rng.rand(2, img, img, 3).astype(np.float32)
    choose = rng.randint(0, img * img, (2, 64)).astype(np.int32)
    choose[:, :5] = [0, img - 1, img * (img - 1), img * img - 1, img + 1]
    m = ModifiedResnet()
    want = jax.jit(lambda v, a, c: m.apply(
        v, a, c, False, method=ModifiedResnet.sparse_points))(
        _sub(trees, "rgb_cam_extractor"), jnp.asarray(rgb), jnp.asarray(choose))
    with torch.no_grad():
        enc = port.rgb_cam_extractor
        got = enc.sparse_points(torch.from_numpy(rgb), torch.from_numpy(choose))
        dense = gather_by_choose(enc(torch.from_numpy(rgb)),
                                 torch.from_numpy(choose))
    _close(got, want)
    # the sparse head equals the dense map at the chosen pixels
    _close(got, dense.numpy(), atol=1e-5)


def test_pointnet2_msg_matches_flax(models):
    from istnet_tpu.nn.pointnet2_msg import PointNet2MSG

    port, trees = models
    pts = (np.random.RandomState(2).randn(2, 128, 3) * 0.1).astype(np.float32)
    m = PointNet2MSG(radii_list=CAM_RADII, npoints=TINY)
    want = jax.jit(lambda v, p: m.apply(v, p, False))(
        _sub(trees, "pts_cam_extractor"), jnp.asarray(pts))
    with torch.no_grad():
        got = port.pts_cam_extractor(torch.from_numpy(pts))
    assert got.shape == (2, 128, 128)
    _close(got, want)


def test_implicit_transform_and_heavy_estimator_match_flax(models):
    from istnet_tpu.nn.estimators import HeavyEstimator, ImplicitTransformation

    port, trees = models
    rng = np.random.RandomState(3)
    pts = (rng.randn(2, 64, 3) * 0.1).astype(np.float32)
    rgb_local = rng.rand(2, 64, 128).astype(np.float32)
    pts_local = rng.rand(2, 64, 128).astype(np.float32)
    cls = np.array([4, 1], np.int32)
    jit = ImplicitTransformation(6)
    w_pts_w, w_local_w = jax.jit(lambda v, *a: jit.apply(v, *a))(
        _sub(trees, "implicit_transform"), jnp.asarray(rgb_local),
        jnp.asarray(pts_local), jnp.asarray(pts), jnp.asarray(cls))
    jhe = HeavyEstimator()
    w_r, w_t, w_s = jax.jit(lambda v, *a: jhe.apply(v, *a))(
        _sub(trees, "main_estimator"), jnp.asarray(pts), w_pts_w,
        jnp.asarray(rgb_local), jnp.asarray(pts_local), w_local_w)
    t = {k: torch.from_numpy(v) for k, v in
         dict(pts=pts, rgb=rgb_local, loc=pts_local, cls=cls).items()}
    with torch.no_grad():
        pts_w, local_w = port.implicit_transform(t["rgb"], t["loc"], t["pts"],
                                                 t["cls"])
        r, tr, s = port.main_estimator(t["pts"], pts_w, t["rgb"], t["loc"],
                                       local_w)
    _close(pts_w, w_pts_w)
    _close(local_w, w_local_w)
    for got, want in ((r, w_r), (tr, w_t), (s, w_s)):
        _close(got, want)


def test_light_estimator_matches_flax(models):
    from istnet_tpu.nn.estimators import LightEstimator

    port, trees = models
    rng = np.random.RandomState(4)
    pts = (rng.randn(2, 64, 3) * 0.1).astype(np.float32)
    rgb_local = rng.rand(2, 64, 128).astype(np.float32)
    pts_local = rng.rand(2, 64, 128).astype(np.float32)
    m = LightEstimator()
    want = jax.jit(lambda v, *a: m.apply(v, *a))(
        _sub(trees, "cam_enhancer"), jnp.asarray(pts), jnp.asarray(rgb_local),
        jnp.asarray(pts_local))
    with torch.no_grad():
        got = port.cam_enhancer(torch.from_numpy(pts),
                                torch.from_numpy(rgb_local),
                                torch.from_numpy(pts_local))
    for g, w in zip(got, want):
        _close(g, w)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_resizes_match_jax():
    from istnet_tpu.nn import layers as jl

    rng = np.random.RandomState(0)
    x = rng.rand(2, 5, 7, 3).astype(np.float32)
    t = torch.from_numpy(x)
    _close(layers.resize_bilinear_align_corners(t, 10, 14),
           jl.resize_bilinear_align_corners(jnp.asarray(x), 10, 14), atol=1e-6)
    for size in (1, 2, 3, 6):
        p = rng.rand(2, size, size, 4).astype(np.float32)
        _close(layers.resize_bilinear(torch.from_numpy(p), 24, 24),
               jl.resize_bilinear(jnp.asarray(p), 24, 24), atol=1e-6)
    with pytest.raises(ValueError, match="upsamples only"):
        layers.resize_bilinear(t, 2, 2)
    y = rng.rand(2, 6, 6, 4).astype(np.float32)
    for size in (1, 2, 3, 6):
        _close(layers.adaptive_avg_pool(torch.from_numpy(y), size),
               jl.adaptive_avg_pool(jnp.asarray(y), size), atol=1e-6)


def test_conv3x3_on_doubled_matches_jax_and_direct_conv():
    from istnet_tpu.nn import layers as jl

    rng = np.random.RandomState(1)
    x = rng.randn(2, 6, 5, 8).astype(np.float32)
    k = (rng.randn(3, 3, 8, 4) * 0.1).astype(np.float32)
    b = rng.randn(4).astype(np.float32)
    got = layers.conv3x3_on_doubled(torch.from_numpy(x), torch.from_numpy(k),
                                    torch.from_numpy(b))
    _close(got, jl.conv3x3_on_doubled(jnp.asarray(x), jnp.asarray(k),
                                      jnp.asarray(b)), atol=1e-5)
    conv = torch.nn.Conv2d(8, 4, 3, padding=1)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
        up = layers.resize_bilinear_align_corners(torch.from_numpy(x), 12, 10)
        _close(got, layers.conv2d_nhwc(up, conv).numpy(), atol=1e-5)


def test_batchnorm_prelu_dropout_match_flax():
    from istnet_tpu.nn import layers as jl

    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 6).astype(np.float32)
    mean, var = rng.randn(6).astype(np.float32), rng.uniform(0.5, 2, 6).astype(np.float32)
    scale, bias = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    bn = layers.BatchNorm(6).eval()
    with torch.no_grad():
        for t, v in ((bn.running_mean, mean), (bn.running_var, var),
                     (bn.weight, scale), (bn.bias, bias)):
            t.copy_(torch.from_numpy(v))
        got = bn(torch.from_numpy(x))
    want = jl.BatchNorm().apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean, "var": var}}, jnp.asarray(x), False)
    _close(got, want, atol=1e-6)
    prelu = layers.PReLU(0.3)
    with torch.no_grad():
        _close(prelu(torch.from_numpy(x)),
               jl.PReLU().apply({"params": {"alpha": np.array([0.3], np.float32)}},
                                jnp.asarray(x)), atol=0)
    t = torch.from_numpy(x)
    assert layers.Dropout2d(0.5).eval()(t) is t          # identity at eval
    # training: dropout draws only from an explicit generator, and BN
    # normalises with batch statistics (tests/test_torch_train_ops.py)
    with pytest.raises(ValueError, match="Generator"):
        layers.Dropout2d(0.5).train()(t)
    with torch.no_grad():
        bn.train()(t)
    torch.testing.assert_close(bn.batch_mean, t.mean(dim=(0, 1)))


def test_ortho6d_matches_jax():
    from istnet_tpu.nn.rotation import ortho6d_to_mat as jax_ortho

    rng = np.random.RandomState(0)
    a, b = rng.randn(8, 3).astype(np.float32), rng.randn(8, 3).astype(np.float32)
    got = ortho6d_to_mat(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, jax_ortho(jnp.asarray(a), jnp.asarray(b)), atol=1e-6)
