"""The port's training ops against the JAX package, on the CPU.

- The plain versions of kernels 8 (multi-radius ball query) and 10 (3-NN)
  against the JAX Pallas kernels in interpret mode: indices equal,
  distances to 1e-6.
- The backward passes of the grouping and of the FP interpolation, in the
  plain versions of the kernels the card's autograd Functions run (kernel
  8 + the grouping scatter, kernel 10 + the interpolation scatter), and
  the CPU route's plain autograd: against ``jax.vjp`` of the JAX custom
  VJPs in interpret mode, on the same cotangent, rtol 1e-5 (the scatters
  sum in another order). The Functions themselves take CUDA tensors only
  (``tests/test_torch_gpu.py``).
- The same with bf16 cotangents (the plain versions read them exactly and
  sum in float32), against the VJPs' bf16 branches.
- The inversion both scatters run on the card, in its plain version
  (``invert_index``), against ``numpy.argsort(kind="stable")`` on the
  path's index maps.
- BatchNorm in train mode, Dropout2d, the losses (``chamfer_dis`` too, in
  float64 to 1e-12 and float32 to 1e-6) and the schedules.

Inputs are made from numpy seeds and handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu_torch import ops
from istnet_tpu_torch.models import losses
from istnet_tpu_torch.models.ist_net import CAM_RADII, WORLD_RADII
from istnet_tpu_torch.nn import layers
from istnet_tpu_torch.ops import pointnet2 as plain
from istnet_tpu_torch.train import schedules

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _cloud(seed, b, n, scale):
    return (np.random.RandomState(seed).randn(b, n, 3) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Kernel 8: multi-radius ball query
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radii", [CAM_RADII[1], CAM_RADII[3], WORLD_RADII[0],
                                   WORLD_RADII[3]],
                         ids=["cam2", "cam4", "world1", "world4"])
def test_ball_query_multi_matches_pallas(radii):
    from istnet_tpu.ops.ball_query_pallas import ball_query_multi_pallas

    xyz = _cloud(0, 2, 256, 0.1)
    cent = np.concatenate([xyz[:, :60], _cloud(1, 2, 4, 0.1) + 5.0], axis=1)
    got = plain.ball_query_multi(radii, (16, 32), _t(xyz), _t(cent))
    want = ball_query_multi_pallas(radii, (16, 32), jnp.asarray(xyz),
                                   jnp.asarray(cent), interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[0][:, 60:] == 0).all()                  # no hit: point 0


# ---------------------------------------------------------------------------
# Kernel 10: 3-NN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m", [(128, 64), (256, 128), (128, 100)])
def test_three_nn_matches_pallas(n, m):
    from istnet_tpu.ops.three_nn_pallas import three_nn_pallas

    unknown = _cloud(2, 2, n, 0.3)
    known = np.concatenate([unknown[:, :m // 2], _cloud(3, 2, m - m // 2, 0.3)],
                           axis=1)
    dist, idx = plain.three_nn(_t(unknown), _t(known))
    w_dist, w_idx = three_nn_pallas(jnp.asarray(unknown), jnp.asarray(known),
                                    interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(w_dist), rtol=0,
                               atol=1e-6)
    assert (dist[:, : m // 2, 0] == 0).all()            # their own neighbours


def test_three_nn_ties_go_to_the_lower_index():
    known = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0], [0, -1.0, 0]]])
    dist, idx = plain.three_nn(torch.zeros(1, 1, 3), known)
    assert idx.tolist() == [[[0, 1, 2]]]
    torch.testing.assert_close(dist, torch.ones(1, 1, 3))


# ---------------------------------------------------------------------------
# The grouping backward against the JAX custom VJP
# ---------------------------------------------------------------------------

def _bqg_inputs(seed=4, c=5):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(2, 128, 3) * 0.2).astype(np.float32)
    cent = (rng.randn(2, 128, 3) * 0.2).astype(np.float32)
    cent[1, :20] += 50.0                                  # rows with no hit
    feats = rng.randn(2, 128, c).astype(np.float32)
    return xyz, cent, feats


@pytest.mark.parametrize("with_features", [True, False])
def test_grouping_function_gradients_match_jax_vjp(with_features):
    """The setup of ``tests/test_pallas_kernels.py:94-120`` (pad slots,
    two radii, plus rows without a hit): the same cotangent through the
    TPU kernel's custom VJP (``_bqg_bwd``, ``jax.vjp`` in interpret mode)
    and through the plain versions of what ``BallQueryGroup.backward``
    runs on the card, kernel 8's neighbour lists and the grouping scatter;
    also through the CPU route, ``ops.ball_query_group``'s plain
    autograd."""
    from istnet_tpu.ops.ball_query_pallas import ball_query_group

    xyz, cent, feats = _bqg_inputs()
    radii, nsamples = (0.15, 0.4), (4, 8)
    feats = feats if with_features else None
    c = 3 + (feats.shape[-1] if with_features else 0)
    rng = np.random.RandomState(5)
    cots = [rng.randn(2, 128, ns, c).astype(np.float32) for ns in nsamples]

    idx = plain.ball_query_multi(radii, nsamples, _t(xyz), _t(cent))
    points_bar, centroid_bar = plain.group_scatter(idx, [_t(g) for g in cots],
                                                   128)
    scattered = [points_bar[..., :3], centroid_bar, points_bar[..., 3:]]
    t_in = [_t(xyz, True), _t(cent, True)] + ([_t(feats, True)]
                                              if with_features else [None])
    outs = ops.ball_query_group(radii, nsamples, *t_in)
    routed = torch.autograd.grad(outs, [t for t in t_in if t is not None],
                                 [_t(g) for g in cots])

    def f(x, cen, *fe):
        return tuple(ball_query_group(radii, nsamples, True, True, x, cen,
                                      fe[0] if fe else None))

    j_in = [jnp.asarray(xyz), jnp.asarray(cent)] + (
        [jnp.asarray(feats)] if with_features else [])
    j_out, vjp = jax.vjp(f, *j_in)
    want = vjp(tuple(jnp.asarray(g) for g in cots))
    for o, jo in zip(outs, j_out):                 # the forwards agree
        np.testing.assert_array_equal(o.detach().numpy(), np.asarray(jo))
    for s_, r, w, name in zip(scattered, routed, want,
                              ("xyz", "new_xyz", "features")):
        for g in (s_, r):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                       atol=1e-5, err_msg=name)


def test_group_scatter_is_the_transpose_of_the_grouping():
    """The plain scatter of the grouping kernel's backward equals autograd
    through the plain grouping (gather -> scatter-add), pad slots and
    empty rows included."""
    xyz, cent, feats = _bqg_inputs(seed=6, c=7)
    radii, nsamples = (0.15, 0.4), (4, 8)
    t_in = [_t(xyz, True), _t(cent, True), _t(feats, True)]
    outs = plain.ball_query_group(radii, nsamples, *t_in)
    cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(i))
            for i, o in enumerate(outs)]
    want = torch.autograd.grad(outs, t_in, cots)
    idx = plain.ball_query_multi(radii, nsamples, t_in[0], t_in[1])
    points_bar, centroid_bar = plain.group_scatter(idx, cots, 128)
    torch.testing.assert_close(points_bar[..., :3], want[0], rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(centroid_bar, want[1], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(points_bar[..., 3:], want[2], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The FP backward: FPInterpolate against the JAX custom VJP
# ---------------------------------------------------------------------------

def test_fp_function_feature_gradient_matches_jax_vjp():
    """``tests/test_pallas_kernels.py:245-271``: the gradient flows into
    the features only, as the TPU kernel's custom VJP (``_fpi_bwd``) sends
    it. Held to it: the plain versions of what ``FPInterpolate.backward``
    runs on the card (kernel 10's 3-NN, the weights, the interpolation
    scatter), and the CPU route, ``ops.fp_interpolate``'s plain
    autograd."""
    from istnet_tpu.ops.three_nn_pallas import fp_interpolate

    rng = np.random.RandomState(8)
    unknown = (rng.randn(2, 128, 3) * 0.3).astype(np.float32)
    known = (rng.randn(2, 64, 3) * 0.3).astype(np.float32)
    feats = rng.randn(2, 64, 6).astype(np.float32)
    cot = rng.randn(2, 128, 6).astype(np.float32)
    dist, idx = plain.three_nn(_t(unknown), _t(known))
    scattered = plain.three_interpolate_grad(
        _t(cot), idx, plain.three_interpolate_weights(dist), 64)
    u, k, f = _t(unknown, True), _t(known, True), _t(feats, True)
    out = ops.fp_interpolate(u, k, f)
    gu, gk, gf = torch.autograd.grad(out, (u, k, f), _t(cot),
                                     allow_unused=True,
                                     materialize_grads=True)
    j_out, vjp = jax.vjp(lambda a, b_, c: fp_interpolate(a, b_, c, True),
                         jnp.asarray(unknown), jnp.asarray(known),
                         jnp.asarray(feats))
    wu, wk, wf = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=1e-5, atol=1e-5)
    for g in (scattered, gf):
        np.testing.assert_allclose(g.numpy(), np.asarray(wf), rtol=1e-5,
                                   atol=1e-5)
    for g, w in ((gu, wu), (gk, wk)):
        np.testing.assert_array_equal(np.asarray(w), 0.0)
        assert torch.equal(g, torch.zeros_like(g))


def test_interp_scatter_is_the_transpose_of_the_interpolation():
    rng = np.random.RandomState(9)
    feats = _t(rng.randn(2, 40, 5).astype(np.float32), True)
    idx = _t(rng.randint(0, 40, (2, 70, 3)).astype(np.int32))
    weight = _t(rng.rand(2, 70, 3).astype(np.float32))
    cot = _t(rng.randn(2, 70, 5).astype(np.float32))
    (want,) = torch.autograd.grad(plain.three_interpolate(feats, idx, weight),
                                  feats, cot)
    torch.testing.assert_close(plain.three_interpolate_grad(cot, idx, weight, 40),
                               want, rtol=1e-5, atol=1e-6)


def _bf16(a):
    """bf16 values of ``a`` as float32 numpy (exact) and as a bf16 tensor."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t.float().numpy(), t


@pytest.mark.parametrize("with_features", [True, False])
def test_grouping_scatter_bf16_cotangents_match_jax_vjp(with_features):
    """bf16 cotangents, the bf16 policy's grouped outputs: the setup of
    ``tests/test_pallas_kernels.py:123`` (``_bqg_bwd``'s bf16 one-hot
    branch, interpret mode), plus rows without a hit, held to the plain
    versions of what ``BallQueryGroup.backward`` runs on the card. bf16
    values are exact in float32 and both sides sum in float32, so they
    differ by summation order only (rtol 1e-5, as in float32)."""
    from istnet_tpu.ops.ball_query_pallas import ball_query_group

    xyz, cent, feats = _bqg_inputs(seed=11)
    radii, nsamples = (0.15, 0.4), (4, 8)
    feats = feats if with_features else None
    c = 3 + (feats.shape[-1] if with_features else 0)
    rng = np.random.RandomState(12)
    cots = [_bf16(rng.randn(2, 128, ns, c)) for ns in nsamples]

    idx = plain.ball_query_multi(radii, nsamples, _t(xyz), _t(cent))
    points_bar, centroid_bar = plain.group_scatter(idx, [t for _, t in cots],
                                                   128)
    assert points_bar.dtype == centroid_bar.dtype == torch.float32

    def f(x, cen, *fe):
        return tuple(ball_query_group(radii, nsamples, True, True, x, cen,
                                      fe[0] if fe else None, jnp.bfloat16))

    j_in = [jnp.asarray(xyz), jnp.asarray(cent)] + (
        [jnp.asarray(feats)] if with_features else [])
    _, vjp = jax.vjp(f, *j_in)
    want = vjp(tuple(jnp.asarray(a).astype(jnp.bfloat16) for a, _ in cots))
    got = [points_bar[..., :3], centroid_bar, points_bar[..., 3:]]
    for g, w, name in zip(got, want, ("xyz", "new_xyz", "features")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_fp_scatter_bf16_cotangent_matches_jax_vjp():
    """bf16 features and cotangent through ``_fpi_bwd`` (interpret mode),
    which sums in float32 and rounds the gradient once to bf16, against
    the plain interpolation scatter, which keeps the float32 sum: they
    differ by that one rounding, at most 2^-8 of each value."""
    from istnet_tpu.ops.three_nn_pallas import fp_interpolate

    rng = np.random.RandomState(13)
    unknown = (rng.randn(2, 128, 3) * 0.3).astype(np.float32)
    known = (rng.randn(2, 64, 3) * 0.3).astype(np.float32)
    feats, _ = _bf16(rng.randn(2, 64, 6))
    cot, t_cot = _bf16(rng.randn(2, 128, 6))
    dist, idx = plain.three_nn(_t(unknown), _t(known))
    got = plain.three_interpolate_grad(
        t_cot, idx, plain.three_interpolate_weights(dist), 64)
    assert got.dtype == torch.float32
    _, vjp = jax.vjp(lambda a, b_, c: fp_interpolate(a, b_, c, True),
                     jnp.asarray(unknown), jnp.asarray(known),
                     jnp.asarray(feats).astype(jnp.bfloat16))
    want = vjp(jnp.asarray(cot).astype(jnp.bfloat16))[2]
    assert want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=2.0 ** -8, atol=1e-6)


def _grouping_keys():
    """SA stage 2's index maps (camera radii, 16 + 32 slots) flattened in
    (radius, centroid, slot) order, as the grouping scatter inverts them:
    pad slots repeat a row's first hit, 4 far centroids have no hit
    (point 0)."""
    xyz = _cloud(20, 2, 256, 0.1)
    cent = np.concatenate([xyz[:, :60], _cloud(21, 2, 4, 0.1) + 5.0], axis=1)
    idx = plain.ball_query_multi(CAM_RADII[1], (16, 32), _t(xyz), _t(cent))
    assert (idx[0][:, 60:] == 0).all()                          # no hit
    assert (idx[1][..., -1] == idx[1][..., 0]).any()            # pad slots
    return torch.cat([i.reshape(2, -1) for i in idx], dim=1), 256


def _interpolation_keys():
    unknown = _cloud(22, 2, 128, 0.3)
    known = np.concatenate([unknown[:, :32], _cloud(23, 2, 32, 0.3)], axis=1)
    _, idx = plain.three_nn(_t(unknown), _t(known))
    return idx.reshape(2, -1), 64


@pytest.mark.parametrize("case", ["grouping", "interpolation", "one_point",
                                  "sparse", "empty"])
def test_invert_index_matches_stable_argsort(case):
    """The plain inversion: per sample, the entries grouped by the row they
    name, ascending inside a row (a stable sort), and CSR offsets. Rows
    without an entry stay empty; ``one_point``: one point named by every
    slot, the longest list; ``sparse``: most rows empty."""
    rng = np.random.RandomState(24)
    if case == "grouping":
        keys, rows = _grouping_keys()
    elif case == "interpolation":
        keys, rows = _interpolation_keys()
    elif case == "one_point":
        keys, rows = torch.full((2, 64 * 48), 5, dtype=torch.int32), 128
    elif case == "sparse":
        keys = _t(rng.randint(0, 1000, (3, 700)).astype(np.int32))
        rows = 1000
    else:
        keys, rows = torch.zeros(2, 0, dtype=torch.int32), 7
    order, offsets = plain.invert_index(keys, rows)
    k = keys.numpy()
    assert order.dtype == offsets.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(k, axis=1, kind="stable"))
    counts = np.stack([np.bincount(r, minlength=rows) for r in k]) if k.size \
        else np.zeros((k.shape[0], rows), np.int64)
    np.testing.assert_array_equal(
        offsets.numpy(),
        np.concatenate([np.zeros((k.shape[0], 1)), counts.cumsum(1)], 1))


@pytest.mark.parametrize("route", ["function", "dispatch"])
def test_fp_gradient_has_no_nan_at_zero_distance(route):
    """The unknown set contains the known set (as an SA stage's centres lie
    in its input), so some 3-NN distances are exactly 0; ``sqrt`` there
    must not turn into NaN gradients (the JAX package's fix in
    ``istnet_tpu/ops/dispatch.py:55-70``). ``function``: the plain
    versions of the steps of ``FPInterpolate.backward``; ``dispatch``: the
    CPU route's plain autograd."""
    rng = np.random.RandomState(10)
    unknown = _t((rng.randn(2, 64, 3) * 0.3).astype(np.float32), True)
    known = unknown[:, :16]
    feats = _t(rng.randn(2, 16, 4).astype(np.float32), True)
    if route == "function":
        dist, idx = plain.three_nn(unknown.detach(), known.detach())
        assert (dist[..., 0][:, :16] == 0).all()
        grad = plain.three_interpolate_grad(
            torch.ones(2, 64, 4), idx, plain.three_interpolate_weights(dist),
            16)
        assert torch.isfinite(grad).all() and grad.abs().max() > 0
        return
    out = ops.fp_interpolate(unknown, known, feats)
    assert torch.isfinite(out).all()
    out.square().sum().backward()
    assert torch.isfinite(feats.grad).all() and feats.grad.abs().max() > 0
    assert unknown.grad is None or torch.isfinite(unknown.grad).all()


def test_fps_takes_points_that_require_grad():
    xyz = _t(_cloud(11, 2, 64, 0.2), True)
    idx = ops.furthest_point_sample(xyz, 8)
    assert not idx.requires_grad
    assert torch.equal(idx, plain.furthest_point_sample(xyz.detach(), 8))


# ---------------------------------------------------------------------------
# BatchNorm, Dropout2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shift,tol", [(0.0, 1e-6), (3.0, 2e-3)],
                         ids=["centred", "shifted"])
def test_batchnorm_train_matches_flax(shift, tol):
    """Train-mode BN against JAX ``BatchNorm`` with ``mutable=["bn_batch"]``:
    the output and the published batch mean and unbiased variance, and
    both against float64. The port's variance is two-pass, JAX's float32
    variance one-pass. On a centred input the two agree to float32
    rounding (measured 1.0e-7 of the output, 2.7e-7 of the variance). On an
    input whose mean is 30 of its standard deviations (``shifted``, as SA
    relative-xyz activations can be) JAX's cancellation shows: its output
    is 3.0e-4 and its variance 6.4e-4 relative off float64, while the port
    stays within 3.2e-7 of it. ``tol`` bounds port vs JAX at ~3x those."""
    from istnet_tpu.nn import layers as jl

    rng = np.random.RandomState(12)
    x = (rng.randn(4, 9, 5, 6) * 0.1 + shift).astype(np.float32)
    scale, bias = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    bn = layers.BatchNorm(6).train()
    with torch.no_grad():
        bn.weight.copy_(_t(scale))
        bn.bias.copy_(_t(bias))
    got = bn(_t(x)).detach().numpy()
    want, mut = jl.BatchNorm().apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": np.zeros(6, np.float32),
                         "var": np.ones(6, np.float32)}},
        jnp.asarray(x), True, mutable=["bn_batch"])
    want, bm, bv = (np.asarray(want), np.asarray(mut["bn_batch"]["mean"]),
                    np.asarray(mut["bn_batch"]["var"]))
    rows = x.astype(np.float64).reshape(-1, 6)
    y64 = ((x - rows.mean(0)) / np.sqrt(rows.var(0) + 1e-5)) * scale + bias
    assert np.abs(got - y64).max() <= 1e-6 * np.abs(y64).max()
    assert np.abs(bn.batch_var.numpy() - rows.var(0, ddof=1)).max() <= (
        1e-6 * rows.var(0).max())
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    np.testing.assert_allclose(bn.batch_mean.numpy(), bm, rtol=0, atol=1e-5)
    assert np.abs(bn.batch_var.numpy() - bv).max() <= tol * bv.max()
    # the forward publishes; it never touches the running statistics
    assert torch.equal(bn.running_mean, torch.zeros(6))
    assert torch.equal(bn.running_var, torch.ones(6))


def test_dropout2d_drops_whole_channels_from_its_generator():
    x = torch.randn(3, 4, 5, 64, generator=torch.Generator().manual_seed(0))
    drop = layers.Dropout2d(0.3).train()
    a = drop(x, torch.Generator().manual_seed(7))
    b = drop(x, torch.Generator().manual_seed(7))
    c = drop(x, torch.Generator().manual_seed(8))
    assert torch.equal(a, b) and not torch.equal(a, c)  # reproducible
    kept = (a != 0).all(dim=(1, 2), keepdim=True)      # per (B, 1, 1, C)
    dropped = (a == 0).all(dim=(1, 2), keepdim=True)
    assert torch.all(kept ^ dropped)                   # whole channels
    assert torch.equal(a, x * kept * np.float32(1.0 / 0.7))  # scaled by 1/keep
    assert 0.5 < kept.float().mean() < 0.9
    assert drop.eval()(x) is x                         # identity at eval
    assert torch.equal(layers.Dropout2d(1.0).train()(x), torch.zeros_like(x))
    with pytest.raises(ValueError, match="Generator"):
        layers.Dropout2d(0.3).train()(x)               # no global RNG


# ---------------------------------------------------------------------------
# Losses and schedules
# ---------------------------------------------------------------------------

def test_losses_match_jax():
    from istnet_tpu.models import losses as jlosses

    rng = np.random.RandomState(13)
    p1, p2 = rng.randn(2, 50, 3) * 0.2, rng.randn(2, 50, 3) * 0.2
    a, b = rng.randn(2, 50, 8), rng.randn(2, 50, 8)
    pose = [rng.randn(4, 3, 3), rng.randn(4, 3), rng.rand(4, 3),
            rng.randn(4, 3, 3), rng.randn(4, 3), rng.rand(4, 3)]
    pose = [v.astype(np.float32) for v in pose]
    for got, want in (
            (losses.smooth_l1_dis(_t(p1), _t(p2)),
             jlosses.smooth_l1_dis(jnp.asarray(p1), jnp.asarray(p2))),
            (losses.feature_mse(_t(a), _t(b)),
             jlosses.feature_mse(jnp.asarray(a), jnp.asarray(b))),
            (losses.pose_dis(*map(_t, pose)),
             jlosses.pose_dis(*map(jnp.asarray, pose)))):
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype,rtol", [("float64", 1e-12),
                                        ("float32", 1e-6)])
def test_chamfer_dis_matches_jax(dtype, rtol):
    """The symmetric Chamfer distance of two sets of unequal sizes."""
    from istnet_tpu.models import losses as jlosses

    rng = np.random.RandomState(17)
    p1 = (rng.randn(3, 40, 3) * 0.2).astype(dtype)
    p2 = (rng.randn(3, 25, 3) * 0.2 + 0.05).astype(dtype)
    got = losses.chamfer_dis(_t(p1), _t(p2))
    assert got.dtype == getattr(torch, dtype)
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        want = float(jlosses.chamfer_dis(jnp.asarray(p1), jnp.asarray(p2)))
    finally:
        jax.config.update("jax_enable_x64", False)
    np.testing.assert_allclose(float(got), want, rtol=rtol, atol=0)


def test_pose_dis_gradient_at_a_zero_difference_is_zero():
    """An exact-zero pose difference (a converged run reaches one) gives a
    zero gradient, not NaN."""
    r = torch.eye(3).expand(2, 3, 3).clone().requires_grad_()
    t = torch.zeros(2, 3, requires_grad=True)
    s = torch.ones(2, 3, requires_grad=True)
    loss = losses.pose_dis(r, t, s, torch.eye(3).expand(2, 3, 3),
                           torch.zeros(2, 3), torch.ones(2, 3))
    loss.backward()
    assert float(loss) == 0.0
    for g in (r.grad, t.grad, s.grad):
        assert torch.equal(g, torch.zeros_like(g))


def test_schedules_equal_jax():
    from istnet_tpu.train import schedules as js

    for step in range(30):
        assert schedules.cyclic_triangular_lr(step, step_size_up=6) == float(
            js.cyclic_triangular_lr(step, step_size_up=6))
        assert schedules.bn_momentum(step, decay_step=2) == float(
            js.bn_momentum(step, decay_step=2))
    assert schedules.cyclic_triangular_lr(0) == np.float32(1e-5)
    assert schedules.bn_momentum(10 ** 6) == np.float32(0.01)


def test_adam_betas_and_eps_overrides_match_jax():
    """``adam_betas`` / ``adam_eps`` reach Adam as the reference's
    ``make_optimizer`` passes them to optax. Three steps (Adam's first is
    +-LR whatever the betas), gradients that change from step to step and
    are small enough (~1e-6) for eps to matter, the LR of each step from
    the cyclic schedule: the updates agree to 1e-6 of the largest, and
    differ from those of the default betas and eps."""
    import optax

    from istnet_tpu.train.train_state import make_optimizer as jax_optimizer
    from istnet_tpu.utils.config import Config
    from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer

    rng = np.random.RandomState(3)
    w0 = rng.randn(6).astype(np.float32)
    grads = [(rng.randn(6) * 1e-6 * (1 + k)).astype(np.float32)
             for k in range(3)]
    # max_epoch 1 x 12 iterations: a half period of 2 steps, so the LR moves
    tx, _ = jax_optimizer(
        Config({"optimizer": {"adam_betas": [0.8, 0.99], "adam_eps": 1e-6,
                              "weight_decay": 0.0}, "max_epoch": 1}),
        12, {"w": jnp.asarray(w0)})
    params = {"w": jnp.asarray(w0)}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = optax.apply_updates(params, updates)
    want = np.asarray(params["w"]) - w0

    def torch_updates(cfg):
        model = torch.nn.Linear(6, 1, bias=False)
        with torch.no_grad():
            model.weight.copy_(torch.from_numpy(w0)[None])
        opt = make_optimizer(model, cfg)
        for step, g in enumerate(grads):
            for group in opt.param_groups:
                group["lr"] = cfg.lr(step)
            model.weight.grad = torch.from_numpy(g)[None].clone()
            opt.step()
        return model.weight.detach()[0].numpy() - w0

    got = torch_updates(TrainConfig(max_epoch=1, iters_per_epoch=12,
                                    adam_betas=(0.8, 0.99), adam_eps=1e-6))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-6 * scale
    default = torch_updates(TrainConfig(max_epoch=1, iters_per_epoch=12))
    assert np.abs(default - want).max() > 1e-2 * scale
