"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest configures JAX.) Shapes are small
and deliberately ragged (point counts that are not multiples of 32 or of a
block, one radius, channel counts that are not multiples of 64, a known
set too large for static shared memory). Indices and grouped values must be
equal; the interpolation agrees to 1e-5 of the largest value and the fold to
1e-4, float32 summation order apart. In bf16 (the bf16 policy's variants
and the fused SA kernel) grouped values are still equal; the interpolation
agrees to 2^-8 of the largest value, the fold to 1e-2 and the fused SA to
2e-2 of max(1, largest), where float32 sums taken in another order round to
bf16 differently.
"""

import numpy as np
import pytest
import torch

from istnet_tpu_torch import ops
from istnet_tpu_torch.entry import build_model, make_inputs
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.ops import fold_upsample, sa_fused
from istnet_tpu_torch.ops import pointnet2 as plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the card)")
    precision.apply_policy()
    ops.reset_launch_counts()
    return torch.device("cuda", 0)


def _f32(a, device):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


@pytest.mark.parametrize("n,npoint", [(2048, 300), (1000, 77), (33, 33)])
def test_fps_kernel(cuda, n, npoint):
    xyz = _f32(np.random.RandomState(n).randn(3, n, 3) * 0.1, cuda)
    assert torch.equal(ops.furthest_point_sample(xyz, npoint),
                       plain.furthest_point_sample(xyz, npoint))
    assert ops.launch_counts()["fps"] == 1


@pytest.mark.parametrize("radii,nsamples,cf", [((0.05, 0.15), (16, 32), 7),
                                               ((0.1,), (64,), 0)])
def test_ball_query_group_kernel(cuda, radii, nsamples, cf):
    rng = np.random.RandomState(1)
    xyz = _f32(rng.randn(2, 300, 3) * 0.1, cuda)
    cent = xyz[:, :45].contiguous()
    feats = _f32(rng.randn(2, 300, cf), cuda) if cf else None
    for got, want in zip(ops.ball_query_group(radii, nsamples, xyz, cent, feats),
                         plain.ball_query_group(radii, nsamples, xyz, cent,
                                                feats)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("n,m,c", [(500, 70, 37), (128, 4000, 8)])
def test_fp_interpolate_kernel(cuda, n, m, c):
    rng = np.random.RandomState(2)
    unknown = _f32(rng.randn(2, n, 3) * 0.1, cuda)
    known = _f32(rng.randn(2, m, 3) * 0.1, cuda)
    feats = _f32(rng.randn(2, m, c), cuda)
    got = ops.fp_interpolate(unknown, known, feats)
    want = plain.fp_interpolate(unknown, known, feats)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("b,h,w,cin,cout,with_ep", [(2, 12, 20, 24, 72, True),
                                                    (1, 5, 3, 10, 64, False),
                                                    (2, 1, 4, 3, 5, True)])
def test_fold_upsample_kernel(cuda, b, h, w, cin, cout, with_ep):
    rng = np.random.RandomState(3)
    x = _f32(rng.randn(b, h, w, cin), cuda)
    k = _f32(rng.randn(3, 3, cin, cout) * 0.1, cuda)
    bias = _f32(rng.randn(cout), cuda)
    ep = _f32(np.stack([rng.randn(cout) * 0.5, rng.uniform(0.5, 2.0, cout),
                        rng.randn(cout) + 1.0, rng.randn(cout) * 0.3,
                        np.full(cout, 0.4)]), cuda) if with_ep else None
    got = ops.fold_upsample_conv(x, k, bias, ep)
    want = fold_upsample.plain(x, k, bias, ep)
    assert got.shape == (b, 2 * h, 2 * w, cout)
    assert (got - want).abs().max() <= 1e-4 * max(1.0, want.abs().max())


def test_wrappers_refuse_grad_requiring_inputs(cuda):
    xyz = torch.zeros(1, 64, 3, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.furthest_point_sample(xyz, 8)
    with torch.no_grad():
        ops.furthest_point_sample(xyz, 8)


def test_card_forward_matches_cpu_forward(cuda):
    model = build_model(sa_npoints=(32, 16, 8, 8), seed=2)
    inputs = make_inputs(2, 128, 48, seed=4)
    with torch.no_grad():
        want = model(inputs)
        model.to(cuda)
        ops.reset_launch_counts()
        got = model({k: v.to(cuda) for k, v in inputs.items()})
    assert ops.launch_counts() == {"fps": 4, "ball_query_group": 4,
                                   "fp_interpolate": 4, "fold_upsample": 1,
                                   "sa_fused": 0}
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4)


# ---------------------------------------------------------------------------
# bf16: the fused SA kernel and the bf16 variants of kernels 2-4
# ---------------------------------------------------------------------------

def _bf16(a, device):
    return _f32(a, device).to(torch.bfloat16)


def _folded(rng, c_in, channels, device):
    layers = []
    for c_out in channels:
        layers.append((_f32(rng.randn(c_in, c_out) * 0.3, device),
                       _f32(rng.randn(c_out) * 0.1, device)))
        c_in = c_out
    return tuple(layers)


@pytest.mark.parametrize("n,m,cf,channels,nsamples", [
    (300, 45, 7, (16, 16, 32), (16, 32)),   # M not a multiple of the tile
    (256, 64, 5, (24,), (16, 32)),          # one layer: the max of layer 1
    (200, 37, 6, (13, 20, 37), (5, 7)),     # widths and ns off every tile
    (512, 96, 0, (16, 16, 32), (16, 32)),   # C = 3, no features (stage 1)
    (128, 20, 4, (32, 64, 64, 128), (64,)),  # depth 4, one radius, ns 64
])
def test_sa_fused_kernel(cuda, n, m, cf, channels, nsamples):
    rng = np.random.RandomState(n + m)
    xyz = _f32(rng.randn(2, n, 3) * 0.2, cuda)
    cent = _f32(rng.randn(2, m, 3) * 0.2, cuda)
    cent[1, : m // 3] += 50.0                 # rows with no hit
    feats = _bf16(rng.randn(2, n, cf), cuda) if cf else None
    radii = (0.15, 0.4)[:len(nsamples)]
    folded = [_folded(rng, 3 + cf, channels, cuda) for _ in nsamples]
    got = ops.sa_msg_fused(radii, nsamples, xyz, cent, feats, folded)
    want = sa_fused.plain(radii, nsamples, xyz, cent, feats, folded)
    assert ops.launch_counts()["sa_fused"] == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (2, m, channels[-1])
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, w.float().abs().max().item())


def test_sa_fused_kernel_identity_mlp_is_the_grouping(cuda):
    """One identity layer on dyadic coordinates: every value is exact, so
    the kernel equals relu(max over slots) of the bf16 grouping, bit for
    bit."""
    rng = np.random.RandomState(9)
    xyz = _f32(rng.randint(-64, 64, size=(2, 256, 3)) / 256.0, cuda)
    xyz[1, 200:] += 64.0
    cent = _f32(rng.randint(-64, 64, size=(2, 100, 3)) / 256.0, cuda)
    feats = _bf16(rng.randn(2, 256, 5), cuda)
    eye = ((torch.eye(8, device=cuda), torch.zeros(8, device=cuda)),)
    radii, nsamples = (0.15, 0.4), (4, 8)
    got = ops.sa_msg_fused(radii, nsamples, xyz, cent, feats, (eye, eye))
    grouped = ops.ball_query_group(radii, nsamples, xyz, cent, feats,
                                   out_dtype=torch.bfloat16)
    for g, gr in zip(got, grouped):
        want = torch.relu(gr.float().amax(dim=2)).to(torch.bfloat16)
        assert torch.equal(g, want)


@pytest.mark.parametrize("feats_dtype", [torch.float32, torch.bfloat16])
def test_ball_query_group_kernel_bf16_out(cuda, feats_dtype):
    rng = np.random.RandomState(4)
    xyz = _f32(rng.randn(2, 300, 3) * 0.1, cuda)
    cent = xyz[:, :45].contiguous()
    feats = _f32(rng.randn(2, 300, 9), cuda).to(feats_dtype)
    args = ((0.05, 0.15), (16, 32), xyz, cent, feats)
    for got, want in zip(ops.ball_query_group(*args, out_dtype=torch.bfloat16),
                         plain.ball_query_group(*args, torch.bfloat16)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("n,m,c", [(500, 70, 37), (1024, 512, 256)])
def test_fp_interpolate_kernel_bf16(cuda, n, m, c):
    rng = np.random.RandomState(5)
    unknown = _f32(rng.randn(2, n, 3) * 0.1, cuda)
    known = _f32(rng.randn(2, m, 3) * 0.1, cuda)
    feats = _bf16(rng.randn(2, m, c), cuda)
    got = ops.fp_interpolate(unknown, known, feats)
    want = plain.fp_interpolate(unknown, known, feats)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want.float()).abs().max()
    assert err <= 2.0 ** -8 * want.float().abs().max()


@pytest.mark.parametrize("b,h,w,cin,cout,with_ep", [(2, 12, 20, 24, 72, True),
                                                    (1, 5, 3, 10, 64, False),
                                                    (2, 48, 48, 256, 64, True)])
def test_fold_upsample_kernel_bf16(cuda, b, h, w, cin, cout, with_ep):
    rng = np.random.RandomState(6)
    x = _bf16(rng.randn(b, h, w, cin), cuda)
    k = _bf16(rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin), cuda)
    bias = _bf16(rng.randn(cout) * 0.1, cuda)
    ep = _f32(np.stack([rng.randn(cout) * 0.5, rng.uniform(0.5, 2.0, cout),
                        rng.randn(cout) + 1.0, rng.randn(cout) * 0.3,
                        np.full(cout, 0.4)]), cuda) if with_ep else None
    got = ops.fold_upsample_conv(x, k, bias, ep)
    want = fold_upsample.plain(x, k, bias, ep)
    assert got.dtype == torch.bfloat16 and got.shape == (b, 2 * h, 2 * w, cout)
    err = (got.float() - want.float()).abs().max()
    assert err <= 1e-2 * max(1.0, want.float().abs().max())


def test_card_bf16_forward_matches_cpu_bf16_forward(cuda):
    model = build_model(sa_npoints=(32, 16, 8, 8), seed=2)
    inputs = make_inputs(2, 128, 48, seed=4)
    old = precision.compute_dtype()
    precision.set_compute_dtype(torch.bfloat16)
    try:
        with torch.no_grad():
            want = model(inputs)
            model.to(cuda)
            ops.reset_launch_counts()
            got = model({k: v.to(cuda) for k, v in inputs.items()})
    finally:
        precision.set_compute_dtype(old)
    assert ops.launch_counts() == {"fps": 4, "ball_query_group": 1,
                                   "fp_interpolate": 4, "fold_upsample": 1,
                                   "sa_fused": 3}
    # measured <= 8.7e-4 (cuDNN and cuBLAS round bf16 after other sums)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=5e-3)
