"""The port's bf16 ops against the JAX package: the fused SA stage (kernel
5 and its twins 6 and 7) and the bf16 variants of kernels 2-4.

Each plain PyTorch op (the CPU path of ``istnet_tpu_torch.ops``, and the
reference its CUDA kernel is held to on the card) runs on the same
numpy-seeded inputs as the JAX Pallas kernels in interpret mode and the JAX
XLA ops, float32 geometry and bf16 values. Tolerances:

- fused SA: 2e-2 * max(1, max |JAX|), the JAX package's own contract
  (``tests/test_sa_fused.py``), against all three TPU kernels; bit-equal on
  the dyadic identity-MLP case, where every value is exact;
- bf16 grouping: equal (one rounding of the same float32 values);
- bf16 FP interpolation: within 1 bf16 ulp of the TPU kernel (float32
  weights and sums, summed in another order);
- bf16 fold + BN + PReLU: ``FOLD_XLA_TOL`` against the XLA fold, which
  rounds at the same points, and ``FOLD_PALLAS_TOL`` against the TPU
  kernel, which rounds at fewer (it adds the bias in float32, ``fold_
  upsample_pallas.py:85``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.ops.sa_fused_pallas import (
    sa_msg_fused_pallas,
    sa_msg_fused_t_l1_pallas,
)
from istnet_tpu_torch import ops
from istnet_tpu_torch.nn.layers import _interp_matrix
from istnet_tpu_torch.ops import fold_upsample, sa_fused
from istnet_tpu_torch.ops import pointnet2 as plain

torch.set_num_threads(1)

RADII, NS = (0.15, 0.4), (4, 8)
SA_TOL = 2e-2
FOLD_XLA_TOL = 2 ** -7       # * max(1, max |want|): one bf16 ulp at 1
FOLD_PALLAS_TOL = 2e-2


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    """A torch or JAX array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _bf16_values(a):
    """float32 numpy values that bf16 represents exactly."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    return t.bfloat16().float().numpy()


def _folded(rng, c_in, channels):
    layers = []
    for c_out in channels:
        layers.append(((rng.randn(c_in, c_out) * 0.3).astype(np.float32),
                       (rng.randn(c_out) * 0.1).astype(np.float32)))
        c_in = c_out
    return layers


def _both(folded_per_radius):
    """numpy (W, b) layers -> (torch folded, JAX folded)."""
    tf = [tuple((_t(w), _t(b)) for w, b in layers)
          for layers in folded_per_radius]
    jf = tuple(tuple((jnp.asarray(w), jnp.asarray(b)) for w, b in layers)
               for layers in folded_per_radius)
    return tf, jf


def _sa_inputs(seed, cf=5, n=128, m=64):
    rng = np.random.RandomState(seed)
    xyz = (rng.randn(2, n, 3) * 0.2).astype(np.float32)
    xyz[1, 100:] += 50.0
    cent = (rng.randn(2, m, 3) * 0.2).astype(np.float32)
    cent[1, :8] -= 50.0                       # centroids with no hit
    feats = _bf16_values(rng.randn(2, n, cf)) if cf else None
    return rng, xyz, cent, feats


def _assert_sa_close(got, want):
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert g.shape == w.shape
        np.testing.assert_allclose(
            _np(g), _np(w), rtol=0,
            atol=SA_TOL * max(1.0, np.abs(_np(w)).max()))


# ---------------------------------------------------------------------------
# Fused SA (kernel 5 and its twins 6, 7)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("l1fuse", ["1", "0"])
@pytest.mark.parametrize("channels", [(16, 16, 32), (16,)])
def test_sa_fused_matches_the_jax_kernels(monkeypatch, l1fuse, channels):
    """``ISTNET_SA_L1FUSE=1`` is kernel 5 (``_sa_fused_kernel_l1``), ``0``
    its twin 6 (``_sa_fused_kernel``, no layer-1 reassociation); a one-layer
    MLP takes the max of layer 1 itself."""
    monkeypatch.setenv("ISTNET_SA_L1FUSE", l1fuse)
    rng, xyz, cent, feats = _sa_inputs(11)
    tf, jf = _both([_folded(rng, 8, channels) for _ in RADII])
    no_hit = plain.pairwise_d2(_t(cent), _t(xyz))[1, :8] >= plain.radius_sq(0.4)
    assert no_hit.all()
    got = sa_fused.plain(RADII, NS, _t(xyz), _t(cent), _t(feats).bfloat16(), tf)
    want = sa_msg_fused_pallas(RADII, NS, jnp.asarray(xyz), jnp.asarray(cent),
                               jnp.asarray(feats).astype(jnp.bfloat16), jf,
                               interpret=True)
    _assert_sa_close(got, want)


@pytest.mark.parametrize("channels", [(8, 8, 16), (16,)])
def test_sa_fused_without_features_matches_the_jax_stage1_kernel(channels):
    """Kernel 7 (``_sa_fused_kernel_t_l1``): stage 1's form, C = 3."""
    rng, xyz, cent, _ = _sa_inputs(3, cf=0)
    tf, jf = _both([_folded(rng, 3, channels) for _ in RADII])
    got = sa_fused.plain(RADII, NS, _t(xyz), _t(cent), None, tf)
    want = sa_msg_fused_t_l1_pallas(RADII, NS, jnp.asarray(xyz),
                                    jnp.asarray(cent), jf, interpret=True)
    _assert_sa_close(got, want)


def test_sa_fused_identity_mlp_is_bit_equal_to_jax_and_the_grouping():
    """``tests/test_sa_fused.py:57-90``'s invariant: on the 2^-8 grid every
    value is exact, so one identity layer gives relu(max over slots) of the
    bf16 grouping, bit for bit, in JAX and in the port."""
    rng = np.random.RandomState(9)
    xyz = rng.randint(-64, 64, size=(2, 128, 3)).astype(np.float32) / 256.0
    xyz[1, 100:] += 64.0
    cent = rng.randint(-64, 64, size=(2, 64, 3)).astype(np.float32) / 256.0
    feats = _bf16_values(rng.randn(2, 128, 5))
    eye = (np.eye(8, dtype=np.float32), np.zeros(8, np.float32))
    tf, jf = _both([[eye], [eye]])
    got = sa_fused.plain(RADII, NS, _t(xyz), _t(cent), _t(feats).bfloat16(), tf)
    want = sa_msg_fused_pallas(RADII, NS, jnp.asarray(xyz), jnp.asarray(cent),
                               jnp.asarray(feats).astype(jnp.bfloat16), jf,
                               interpret=True)
    grouped = plain.ball_query_group(RADII, NS, _t(xyz), _t(cent),
                                     _t(feats).bfloat16(), torch.bfloat16)
    for g, w, gr in zip(got, want, grouped):
        np.testing.assert_array_equal(_np(g), _np(w))
        np.testing.assert_array_equal(
            _np(g), _np(torch.relu(gr.float().amax(dim=2)).bfloat16()))


def test_sa_fused_plain_matches_the_unfused_composition():
    """The port's plain fused stage against its own unfused ops: bf16
    grouping, then each folded layer as relu(bf16(h) @ bf16(W) + b), then
    the max (``tests/test_sa_fused.py:23-34``'s reference)."""
    rng, xyz, cent, feats = _sa_inputs(5, n=96, m=40)
    tf, _ = _both([_folded(rng, 8, (16, 16, 32)) for _ in RADII])
    got = sa_fused.plain(RADII, NS, _t(xyz), _t(cent), _t(feats).bfloat16(), tf)
    grouped = plain.ball_query_group(RADII, NS, _t(xyz), _t(cent),
                                     _t(feats).bfloat16(), torch.bfloat16)
    for g, gr, layers in zip(got, grouped, tf):
        h = gr.float()
        for w, b in layers:
            z = torch.relu(h @ w.bfloat16().float() + b)
            h = z.bfloat16().float()
        want = z.amax(dim=2)
        err = (g.float() - want).abs().max()
        assert err <= SA_TOL * max(1.0, want.abs().max())


# ---------------------------------------------------------------------------
# bf16 grouping (kernel 2), FP interpolation (kernel 3), fold (kernel 4)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("feats_dtype", ["float32", "bfloat16", None])
def test_bf16_grouping_equals_the_jax_kernel(feats_dtype):
    from istnet_tpu.ops.ball_query_pallas import ball_query_group_pallas_t

    rng = np.random.RandomState(3)
    xyz = (rng.randn(2, 128, 3) * 0.2).astype(np.float32)
    cent = (rng.randn(2, 128, 3) * 0.2).astype(np.float32)
    feats = rng.randn(2, 128, 5).astype(np.float32)
    if feats_dtype == "bfloat16":
        feats = _bf16_values(feats)
    tfeats = jfeats = None
    if feats_dtype is not None:
        tfeats = _t(feats).to(getattr(torch, feats_dtype))
        jfeats = jnp.asarray(feats).astype(feats_dtype)
    got = plain.ball_query_group(RADII, NS, _t(xyz), _t(cent), tfeats,
                                 torch.bfloat16)
    want = ball_query_group_pallas_t(RADII, NS, jnp.asarray(xyz),
                                     jnp.asarray(cent), jfeats, True,
                                     interpret=True, out_dtype=jnp.bfloat16)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("m", [128, 100])
def test_bf16_fp_interpolate_within_one_ulp_of_the_jax_kernel(m):
    from istnet_tpu.ops.three_nn_pallas import fp_interpolate_pallas

    rng = np.random.RandomState(6)
    unknown = (rng.randn(2, 128, 3) * 0.3).astype(np.float32)
    known = (rng.randn(2, m, 3) * 0.3).astype(np.float32)
    known[:, :8] = unknown[:, :8]       # exact-zero distances, as at FP stages
    feats = _bf16_values(rng.randn(2, m, 6))
    got = ops.fp_interpolate(_t(unknown), _t(known), _t(feats).bfloat16())
    want = fp_interpolate_pallas(jnp.asarray(unknown), jnp.asarray(known),
                                 jnp.asarray(feats).astype(jnp.bfloat16),
                                 interpret=True)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g, w = _np(got), _np(want)
    ulp = np.ldexp(1.0, np.frexp(np.maximum(np.abs(g), np.abs(w)))[1] - 8)
    assert np.all(np.abs(g - w) <= ulp)


def _fold_inputs(b, h, w, cin, cout, seed=0):
    rng = np.random.RandomState(seed)
    x = _bf16_values(rng.randn(b, h, w, cin))
    k = _bf16_values(rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin))
    bias = _bf16_values(rng.randn(cout) * 0.3)
    ep = np.stack([rng.randn(cout) * 0.5,
                   1.0 / np.sqrt(rng.uniform(0.25, 2.0, cout) + 1e-5),
                   rng.randn(cout) * 0.8 + 1.0, rng.randn(cout) * 0.3,
                   np.full(cout, 0.3)]).astype(np.float32)
    return x, k, bias, ep


@pytest.mark.parametrize("b,h,w,cin,cout", [(2, 8, 8, 16, 8), (1, 6, 4, 8, 4)])
def test_bf16_fold_with_epilogue_matches_jax(b, h, w, cin, cout):
    from istnet_tpu.nn.layers import conv3x3_on_doubled as jax_fold
    from istnet_tpu.ops.fold_upsample_pallas import fold_upsample_conv_pallas

    x, k, bias, ep = _fold_inputs(b, h, w, cin, cout)
    bf = torch.bfloat16
    got = fold_upsample.plain(_t(x).to(bf), _t(k).to(bf), _t(bias).to(bf),
                              _t(ep))
    assert got.dtype == bf
    jx, jk, jb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, k, bias))
    y = jax_fold(jx, jk, jb)
    t = (((y - ep[0]) * ep[1]) * ep[2] + ep[3]).astype(jnp.bfloat16)
    xla = jnp.where(t >= 0, t, jnp.asarray(ep[4]).astype(jnp.bfloat16) * t)
    pallas = fold_upsample_conv_pallas(jx, jk, jb, True,
                                       epilogue=jnp.asarray(ep))
    for want, tol in ((xla, FOLD_XLA_TOL), (pallas, FOLD_PALLAS_TOL)):
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(
            _np(got), _np(want), rtol=0,
            atol=tol * max(1.0, np.abs(_np(want)).max()))


@pytest.mark.parametrize("in_size,out_size", [(48, 96), (6, 12), (1, 2)])
def test_bf16_fold_taps_carry_the_bf16_interp_matrix(in_size, out_size):
    """Under bf16 the kernel's tables carry the bf16-rounded weights the
    plain version's cast gives (so w_lo + w_hi != 1 in general)."""
    idx, w = fold_upsample._taps(in_size, out_size, torch.device("cpu"),
                                 torch.bfloat16)
    a = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(a, (rows, idx[0].numpy()), w[0].numpy())
    np.add.at(a, (rows, idx[1].numpy()), w[1].numpy())
    want = torch.tensor(_interp_matrix(in_size, out_size),
                        dtype=torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(a, want)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_bf16_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    rng, xyz, cent, feats = _sa_inputs(2, n=64, m=16)
    tf, _ = _both([_folded(rng, 8, (8, 16)) for _ in RADII])
    args = (RADII, NS, _t(xyz), _t(cent), _t(feats).bfloat16())
    for g, p in zip(ops.sa_msg_fused(*args, tf), sa_fused.plain(*args, tf)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    for g, p in zip(ops.ball_query_group(*args, out_dtype=torch.bfloat16),
                    plain.ball_query_group(*args, torch.bfloat16)):
        torch.testing.assert_close(g, p, rtol=0, atol=0)
    assert all(v == 0 for v in ops.launch_counts().values())


# ---------------------------------------------------------------------------
# The layouts the tensor-core kernels read (pure tensor code)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf,channels", [(64, (12, 24, 40)), (0, (16, 16, 32)),
                                         (5, (13,)), (128, (64, 64, 128)),
                                         (7, (1, 17, 33, 250))])
def test_pack_folded_round_trips_with_zero_padding(cf, channels):
    """pack -> unpack gives the bf16-rounded folded weights and the biases
    back; every width is padded to the MMA tile of 16 with zeros, layer 1
    keeps its three xyz rows first and pads only its feature rows."""
    rng = np.random.RandomState(cf + len(channels))
    tf, _ = _both([_folded(rng, 3 + cf, channels) for _ in NS])
    packed = sa_fused.pack_folded(tf)
    assert sa_fused.pack_folded(packed) is packed
    assert packed.chans == ((3 + cf, *channels),) * 2
    ceil16 = lambda c: -(-c // 16) * 16
    for layers, back, ws, bs in zip(tf, sa_fused.unpack_folded(packed),
                                    packed.ws, packed.bs):
        c_in = 3 + cf
        for k, ((w, b), (w2, b2), wp, bp) in enumerate(zip(layers, back, ws,
                                                           bs)):
            c_out = w.shape[1]
            rows = 3 + ceil16(cf) if k == 0 else ceil16(c_in)
            assert wp.dtype == torch.bfloat16 and bp.dtype == torch.float32
            assert wp.shape == (rows, ceil16(c_out))
            assert bp.shape == (ceil16(c_out),)
            assert torch.equal(w2, w.bfloat16().float())
            assert torch.equal(b2, b)
            assert not wp[c_in:].any() and not wp[:, c_out:].any()
            assert not bp[c_out:].any()
            c_in = c_out


def test_sa_fused_plain_takes_the_packed_weights_bit_for_bit():
    rng, xyz, cent, feats = _sa_inputs(21, cf=5)
    tf, _ = _both([_folded(rng, 8, (12, 24, 40)) for _ in NS])
    args = (RADII, NS, _t(xyz), _t(cent), _t(feats).bfloat16())
    want = sa_fused.plain(*args, tf)
    for got in (sa_fused.plain(*args, sa_fused.pack_folded(tf)),
                ops.sa_msg_fused(*args, sa_fused.pack_folded(tf))):
        for g, w in zip(got, want):
            assert g.dtype == torch.bfloat16 and torch.equal(g, w)


def test_pack_folded_refuses_layers_that_do_not_chain():
    rng = np.random.RandomState(3)
    tf, _ = _both([_folded(rng, 8, (16, 16))])
    broken = [(tf[0][0], (tf[0][1][0][:-1], tf[0][1][1]))]
    with pytest.raises(ValueError, match="after 16"):
        sa_fused.pack_folded(broken)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout", [(256, 64), (10, 5), (24, 72), (3, 12),
                                      (67, 40)])
def test_pack_kernel_round_trips_with_zero_padding(cin, cout, dtype):
    """The fold GEMM's operand: km[ci, (3 dy + dx) * coutp + c] = k[dy, dx,
    ci, c], channels padded to 8, columns to the 192-wide block tile, depth
    to 32 (float32) or 64 (bf16), zeros in all padding; in bf16 it is stored
    transposed, depth along the rows' memory; unpack gives k back."""
    rng = np.random.RandomState(cin + cout)
    k = _t(rng.randn(3, 3, cin, cout).astype(np.float32)).to(dtype)
    km = fold_upsample.pack_kernel(k)
    coutp = -(-cout // 8) * 8
    depth = 64 if dtype == torch.bfloat16 else 32
    assert km.dtype == dtype and km.is_contiguous()
    assert torch.equal(fold_upsample.unpack_kernel(km, cin, cout), k)
    if dtype == torch.bfloat16:
        km = km.t()
    assert km.shape == (-(-cin // depth) * depth, -(-9 * coutp // 192) * 192)
    assert torch.equal(km[5 % cin, (3 * 2 + 1) * coutp + cout - 1],
                       k[2, 1, 5 % cin, cout - 1])
    mask = torch.zeros(km.shape, dtype=torch.bool)
    mask[:cin, :9 * coutp].view(cin, 9, coutp)[..., :cout] = True
    assert not km[~mask].any()


def test_fold_plain_takes_the_packed_fold_bit_for_bit():
    x, k, b, ep = _fold_inputs(2, 6, 4, 10, 5)
    args = [_t(a).bfloat16() for a in (x, k, b)] + [_t(ep)]
    want = fold_upsample.plain(*args)
    packed = fold_upsample.pack_fold(*args[1:])
    assert torch.equal(fold_upsample.plain(args[0], packed), want)
    assert torch.equal(ops.fold_upsample_conv(args[0], packed), want)
