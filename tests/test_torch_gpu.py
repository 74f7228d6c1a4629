"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest configures JAX.) Shapes are small
and deliberately ragged (point counts that are not multiples of 32 or of a
block, one radius, channel counts that are not multiples of 64, a known
set too large for static shared memory). Indices and grouped values must be
equal; the interpolation agrees to 1e-5 of the largest value and the fold to
1e-4, float32 summation order apart.
"""

import numpy as np
import pytest
import torch

from istnet_tpu_torch import ops
from istnet_tpu_torch.entry import build_model, make_inputs
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.ops import fold_upsample
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
                                   "fp_interpolate": 4, "fold_upsample": 1}
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=1e-4)
