"""The port's point ops and fold-upsample conv against the JAX package.

Each plain PyTorch op (the CPU path of ``istnet_tpu_torch.ops``, and the
reference its CUDA kernel is held to on the card) is compared on the same
numpy-seeded inputs with the JAX Pallas kernel in interpret mode and with
the JAX XLA op, and pinned to the contracts of ``istnet_tpu/ops/golden.py``.
Indices must be equal. Float values agree to float32 summation order:
1e-5 for the 3-NN interpolation, 1e-4 for the fold (a 9*Cin-term sum taken
in another association). The kernels themselves run only on the card:
``tests/test_torch_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.ops import golden
from istnet_tpu.ops import pointnet2 as xla_ops
from istnet_tpu_torch import ops
from istnet_tpu_torch.nn.layers import _interp_matrix
from istnet_tpu_torch.ops import dispatch, fold_upsample
from istnet_tpu_torch.ops import pointnet2 as plain

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# FPS (kernel 1)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,npoint,duplicated", [
    (128, 32, False),
    (33, 33, False),        # N off the 128-lane tiling: XLA and golden only
    (1000, 64, False),
    (2048, 64, False),      # the 2048-point configuration
    (256, 64, True),        # 20 distinct points: ties between the copies
])
def test_fps_matches_pallas_xla_and_golden(n, npoint, duplicated):
    from istnet_tpu.ops.fps_pallas import furthest_point_sample_pallas

    rng = np.random.RandomState(n)
    xyz = (rng.randn(4, n, 3) * 0.3).astype(np.float32)
    if duplicated:
        xyz = xyz[:, rng.randint(0, 20, n)]
    got = plain.furthest_point_sample(_t(xyz), npoint).numpy()
    assert got.dtype == np.int32
    if n % 128 == 0:        # the Pallas kernel takes whole lane tiles only
        np.testing.assert_array_equal(
            got, np.asarray(furthest_point_sample_pallas(
                jnp.asarray(xyz), npoint, interpret=True)))
    np.testing.assert_array_equal(
        got, np.asarray(xla_ops.furthest_point_sample(jnp.asarray(xyz),
                                                      npoint)))
    np.testing.assert_array_equal(got, golden.fps_golden(xyz, npoint))
    assert np.all(got[:, 0] == 0)                     # starts at index 0


def test_fps_ties_go_to_lowest_index():
    # a degenerate cloud: every distance ties, so every pick is index 0
    assert torch.all(plain.furthest_point_sample(torch.zeros(2, 128, 3), 8) == 0)
    # two equally far points: the lower index wins
    xyz = torch.tensor([[[0.0, 0, 0], [0.5, 0, 0], [1.0, 0, 0], [-1.0, 0, 0]]])
    assert plain.furthest_point_sample(xyz, 3).tolist() == [[0, 2, 3]]


# ---------------------------------------------------------------------------
# Ball query + group (kernel 2)
# ---------------------------------------------------------------------------

def _bq_inputs(seed=3, n=128, m=128, c=5):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(2, n, 3) * 0.2).astype(np.float32)
    cent = (rng.randn(2, m, 3) * 0.2).astype(np.float32)
    feats = rng.randn(2, n, c).astype(np.float32)
    return xyz, cent, feats


@pytest.mark.parametrize("with_features,c,nsamples,bf16", [
    (False, 5, (4, 8), False),
    (True, 5, (4, 8), False),
    (True, 7, (64, 16), True),  # C = 7, ns = 64, bf16 features and output
])
def test_ball_query_group_matches_pallas_and_xla(with_features, c, nsamples,
                                                 bf16):
    from istnet_tpu.ops.ball_query_pallas import (
        ball_query_group_pallas,
        ball_query_group_pallas_t,
    )

    xyz, cent, feats = _bq_inputs(c=c)
    feats = feats if with_features else None
    radii = (0.15, 0.4)
    jdt, tdt = ((jnp.bfloat16, torch.bfloat16) if bf16
                else (jnp.float32, torch.float32))
    tf = None if feats is None else _t(feats).to(tdt)
    jf = None if feats is None else jnp.asarray(feats).astype(jdt)
    got = plain.ball_query_group(radii, nsamples, _t(xyz), _t(cent), tf, tdt)
    pallas = ball_query_group_pallas_t(radii, nsamples, jnp.asarray(xyz),
                                       jnp.asarray(cent), jf, True,
                                       interpret=True, out_dtype=jdt)
    # the untransposed twin kernel computes the same function
    twin = ball_query_group_pallas(radii, nsamples, jnp.asarray(xyz),
                                   jnp.asarray(cent), jf, True, interpret=True,
                                   out_dtype=jdt)
    xla = xla_ops.ball_query_group(radii, nsamples, jnp.asarray(xyz),
                                   jnp.asarray(cent), jf, True)
    for g, ns, p, tw, x in zip(got, nsamples, pallas, twin, xla):
        assert g.dtype == tdt
        assert g.shape == (2, 128, ns, 3 + (0 if feats is None else c))
        g = g.float().numpy()
        np.testing.assert_array_equal(g, np.asarray(p.astype(jnp.float32)))
        np.testing.assert_array_equal(g, np.asarray(tw.astype(jnp.float32)))
        # XLA groups in float32; the kernels round once to the output type
        np.testing.assert_array_equal(
            g, np.asarray(x.astype(jdt).astype(jnp.float32)))


@pytest.mark.parametrize("radius,nsample", [(0.2, 8), (0.5, 16), (0.02, 4)])
def test_ball_query_indices_match_xla_and_golden(radius, nsample):
    xyz, _, _ = _bq_inputs(seed=1)
    cent = xyz[:, :64]
    got = plain.ball_query(radius, nsample, _t(xyz), _t(cent)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(xla_ops.ball_query(radius, nsample, jnp.asarray(xyz),
                                           jnp.asarray(cent))))
    np.testing.assert_array_equal(
        got, golden.ball_query_golden(radius, nsample, xyz, cent))


def test_ball_query_group_no_hit_and_padding_contracts():
    # centroid 0 has no point in radius -> every slot is point 0's row;
    # centroid 1 has two hits (points 2 and 5) -> padded with the first hit
    xyz = np.full((1, 8, 3), 5.0, np.float32)
    xyz[0, 2] = [0.01, 0.0, 0.0]
    xyz[0, 5] = [-0.01, 0.0, 0.0]
    cent = np.array([[[9.0, 9.0, 9.0], [0.0, 0.0, 0.0]]], np.float32)
    feats = np.arange(8, dtype=np.float32).reshape(1, 8, 1)
    (g,) = plain.ball_query_group((0.1,), (4,), _t(xyz), _t(cent), _t(feats))
    np.testing.assert_array_equal(g[0, 0, :, 3].numpy(), [0, 0, 0, 0])
    np.testing.assert_array_equal(g[0, 0, :, :3].numpy(),
                                  np.broadcast_to(xyz[0, 0] - cent[0, 0], (4, 3)))
    np.testing.assert_array_equal(g[0, 1, :, 3].numpy(), [2, 5, 2, 2])


# ---------------------------------------------------------------------------
# FP interpolation (kernel 3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [128, 100, 64])
def test_fp_interpolate_matches_pallas_and_xla(m):
    from istnet_tpu.ops.three_nn_pallas import fp_interpolate_pallas

    rng = np.random.RandomState(6)
    unknown = (rng.randn(2, 128, 3) * 0.3).astype(np.float32)
    known = (rng.randn(2, m, 3) * 0.3).astype(np.float32)
    known[:, :8] = unknown[:, :8]       # exact-zero distances, as at FP stages
    feats = rng.randn(2, m, 6).astype(np.float32)
    got = plain.fp_interpolate(_t(unknown), _t(known), _t(feats)).numpy()
    pallas = fp_interpolate_pallas(jnp.asarray(unknown), jnp.asarray(known),
                                   jnp.asarray(feats), interpret=True)
    dist, idx = xla_ops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    xla = xla_ops.three_interpolate(jnp.asarray(feats), idx,
                                    xla_ops.three_interpolate_weights(dist))
    # float32 summation order differs (weighted sum and weight normalisation)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-5, atol=1e-5)


def test_three_nn_matches_xla_and_golden_with_strict_ties():
    rng = np.random.RandomState(2)
    unknown = (rng.randn(2, 64, 3) * 0.3).astype(np.float32)
    known = (rng.randn(2, 32, 3) * 0.3).astype(np.float32)
    known[:, 20] = known[:, 3]          # duplicates: the lower index first
    known[:, 31] = known[:, 3]
    dist, idx = plain.three_nn(_t(unknown), _t(known))
    xd, xi = xla_ops.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(xi))
    np.testing.assert_allclose(dist.numpy(), np.asarray(xd), rtol=1e-5, atol=1e-6)
    gd, gi = golden.three_nn_golden(unknown, known)
    np.testing.assert_array_equal(idx.numpy(), gi)
    np.testing.assert_allclose(dist.numpy(), gd, rtol=1e-4, atol=1e-6)
    nearest_dup = idx.numpy()[:, :, 0] == 3
    assert nearest_dup.any()
    assert np.all(idx.numpy()[nearest_dup][:, 1] == 20)
    assert np.all(idx.numpy()[nearest_dup][:, 2] == 31)


# ---------------------------------------------------------------------------
# Fold-upsample conv (kernel 4)
# ---------------------------------------------------------------------------

def _fold_inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    k = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    ep = np.stack([rng.randn(cout) * 0.5,
                   1.0 / np.sqrt(rng.uniform(0.25, 2.0, cout) + 1e-5),
                   rng.randn(cout) * 0.8 + 1.0, rng.randn(cout) * 0.3,
                   np.full(cout, 0.4)]).astype(np.float32)
    return x, k, bias, ep


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 16, 8), (3, 6, 4, 8, 4)])
def test_fold_upsample_matches_pallas_and_xla(b, h, w, cin, cout):
    from istnet_tpu.nn.layers import conv3x3_on_doubled as jax_fold
    from istnet_tpu.ops.fold_upsample_pallas import fold_upsample_conv_pallas

    x, k, bias, ep = _fold_inputs(b, h, w, cin, cout)
    got = fold_upsample.plain(_t(x), _t(k), _t(bias), _t(ep)).numpy()
    pallas = fold_upsample_conv_pallas(jnp.asarray(x), jnp.asarray(k),
                                       jnp.asarray(bias), True,
                                       epilogue=jnp.asarray(ep))
    y = jax_fold(jnp.asarray(x), jnp.asarray(k), jnp.asarray(bias))
    t = (y - ep[0]) * ep[1] * ep[2] + ep[3]
    xla = jnp.where(t >= 0, t, ep[4] * t)
    # a 9*Cin-term sum in another association
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("in_size,out_size", [(48, 96), (6, 12), (1, 2), (5, 10)])
def test_fold_kernel_taps_rebuild_the_interp_matrix(in_size, out_size):
    """The kernel's per-row (lo, hi, w_lo, w_hi) tables encode exactly the
    float32 interpolation matrix the plain version uses."""
    idx, w = fold_upsample._taps(in_size, out_size, torch.device("cpu"))
    a = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(a, (rows, idx[0].numpy()), w[0].numpy())
    np.add.at(a, (rows, idx[1].numpy()), w[1].numpy())
    np.testing.assert_array_equal(a, _interp_matrix(in_size, out_size)
                                  .astype(np.float32))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    xyz, cent, feats = (_t(a) for a in _bq_inputs(n=64, m=16, c=4))
    idx = ops.furthest_point_sample(xyz, 16)
    torch.testing.assert_close(idx, plain.furthest_point_sample(xyz, 16),
                               rtol=0, atol=0)
    for g, p in zip(ops.ball_query_group((0.2, 0.4), (4, 8), xyz, cent, feats),
                    plain.ball_query_group((0.2, 0.4), (4, 8), xyz, cent, feats)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    torch.testing.assert_close(ops.fp_interpolate(cent, xyz, feats),
                               plain.fp_interpolate(cent, xyz, feats),
                               rtol=0, atol=0)
    x, k, bias, ep = (_t(a) for a in _fold_inputs(1, 4, 4, 8, 4))
    torch.testing.assert_close(ops.fold_upsample_conv(x, k, bias, ep),
                               fold_upsample.plain(x, k, bias, ep),
                               rtol=0, atol=0)
    assert ops.launch_counts() == {name: 0 for name in dispatch.KERNELS}


def test_cuda_wrappers_refuse_cpu_tensors_and_other_devices_raise():
    xyz = torch.zeros(1, 16, 3)
    for name in dispatch.KERNELS:
        wrapper = dispatch.wrapper(name)
        args = {"fps": (xyz, 4),
                "ball_query_group": ((0.1,), (4,), xyz, xyz),
                "fp_interpolate": (xyz, xyz, xyz),
                "fold_upsample": (torch.zeros(1, 2, 2, 4),
                                  torch.zeros(3, 3, 4, 4), None),
                "sa_fused": ((0.1,), (4,), xyz, xyz, None,
                             (((torch.zeros(3, 4), torch.zeros(4)),),)),
                "ball_query": ((0.1,), (4,), xyz, xyz),
                "group_scatter": ([torch.zeros(1, 16, 4, dtype=torch.int32)],
                                  [torch.zeros(1, 16, 4, 3)], 16),
                "three_nn": (xyz, xyz),
                "interp_scatter": (xyz, torch.zeros(1, 16, 3, dtype=torch.int32),
                                   xyz, 16),
                "depth_fill": (torch.zeros(1, 8, 8),),
                "bn_eval": (torch.zeros(2, 4), torch.zeros(4, 4))}[name]
        with pytest.raises(ValueError, match="must be on"):
            wrapper(*args)
    with pytest.raises(ValueError, match="no kernel"):
        ops.furthest_point_sample(torch.zeros(1, 16, 3, device="meta"), 4)
    assert all(v == 0 for v in ops.launch_counts().values())


def test_kernel_build_is_keyed_by_the_sources(tmp_path, monkeypatch):
    """An edit to any CUDA source changes the build directory, so the next
    first use rebuilds."""
    from istnet_tpu_torch.ops import _build

    names = [p.name for p in _build.sources()]
    assert {"fps.cu", "ball_query_group.cu", "fp_interpolate.cu",
            "fold_upsample.cu"} <= set(names)
    for p in _build.sources():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    before = _build._digest()
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._digest() == before
    fps = tmp_path / "fps.cu"
    fps.write_text(fps.read_text() + "\n// edited\n")
    assert _build._digest() != before
