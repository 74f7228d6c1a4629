"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
no JAX, so that it runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest configures JAX.) Shapes are small
and deliberately ragged (point counts that are not multiples of 32 or of a
block, one radius, channel counts that are not multiples of 64, a known
set too large for static shared memory; for the two tensor-core kernels also
M = 1, ns off the 16-row tiles, widths off the MMA multiples, odd maps, B = 1).
Indices and grouped values must be
equal; the interpolation agrees to 1e-5 of the largest value and the fold to
1e-4, float32 summation order apart. In bf16 (the bf16 policy's variants
and the fused SA kernel) grouped values are still equal; the interpolation
agrees to 2^-8 of the largest value, the fold to 1e-2 and the fused SA to
2e-2 of max(1, largest), where float32 sums taken in another order round to
bf16 differently.

Training (float32): the backward kernels (8: multi-radius ball query, the
grouping scatter, 10: 3-NN, the interpolation scatter) against their plain
versions, indices and distances equal, scatters to 1e-5 of the largest
value (they sum each row in a fixed order, the plain versions in theirs)
with float32 and bf16 cotangents, and bit-equal from call to call; their
inversion equal to its plain version; the dispatch ops' gradients on
the card against autograd through the plain ops on the CPU; one tiny train
step on the card against the same step on the CPU. The training loop: 2
Solver steps at full width from a synthetic train tree with each step's
launch counts (IST-Net and PoseNetGT), and a checkpoint written on the card
restored on the CPU and back onto the card. Kernel 1 past 2048 points (both
of its larger layouts). Data parallel: DDP over NCCL at world 1 bit-equal
to the plain card step. The batched Umeyama fit and RANSAC on the card
against the CPU, and the resnet50 encoder's eval forward.
"""

import cv2
import numpy as np
import pytest
import torch

from istnet_tpu_torch import ops
from istnet_tpu_torch.entry import (
    build_model,
    build_train_model,
    make_inputs,
    make_train_batch,
)
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.ops import (
    bn_eval,
    dispatch,
    fold_upsample,
    sa_fused,
    scatter_invert,
)
from istnet_tpu_torch.ops import pointnet2 as plain
from istnet_tpu_torch.train.train_state import (
    TrainConfig,
    make_optimizer,
    train_step,
)

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


def _counts(**launched):
    """Every kernel's launch count: those named, 0 for the others."""
    return {name: launched.get(name, 0) for name in dispatch.KERNELS}


def _eval_bns(model, dtype) -> int:
    """The BatchNorms an eval forward of ``model`` runs as the eval BN
    pass: the encoder's and the camera extractor's, but for up_2's (kernel
    4's epilogue) and, under bf16, those of SA stages 2-4 (folded into
    kernel 5)."""
    skip = {id(m) for m in model.rgb_cam_extractor.model.up_2.modules()}
    if dtype == torch.bfloat16:
        skip |= {id(m) for sa in model.pts_cam_extractor.SA_modules[1:]
                 for m in sa.modules()}
    return sum(isinstance(m, layers.BatchNorm) and id(m) not in skip
               for part in (model.rgb_cam_extractor, model.pts_cam_extractor)
               for m in part.modules())


@pytest.mark.parametrize("n,npoint", [(2048, 300), (1000, 77), (33, 33)])
def test_fps_kernel(cuda, n, npoint):
    xyz = _f32(np.random.RandomState(n).randn(3, n, 3) * 0.1, cuda)
    assert torch.equal(ops.furthest_point_sample(xyz, npoint),
                       plain.furthest_point_sample(xyz, npoint))
    assert ops.launch_counts()["fps"] == 1


@pytest.mark.parametrize("npoint", ["n", 1, 64])
@pytest.mark.parametrize("n", [33, 128, 256, 512, 1000, 1024, 2048])
def test_fps_kernel_every_branch(cuda, n, npoint):
    """Every (warps, points a thread) branch of the kernel's table, with
    npoint = N (the last steps pick points whose minimum is already 0) and
    npoint = 1."""
    npoint = n if npoint == "n" else npoint
    xyz = _f32(np.random.RandomState(n + 1).randn(2, n, 3) * 0.1, cuda)
    assert torch.equal(ops.furthest_point_sample(xyz, npoint),
                       plain.furthest_point_sample(xyz, npoint))


@pytest.mark.parametrize("n,b,npoint", [(2049, 2, 512), (4096, 2, 1024),
                                         (8192, 2, 1024), (20000, 2, 512),
                                         (60000, 1, 128)])
def test_fps_kernel_past_2048_points(cuda, n, b, npoint):
    """Clouds past 2048 points: registers of 16 warps to 8192, then the
    stream kernel with its minima in shared memory (20000) or in the
    wrapper's workspace (60000); ties among duplicated points too."""
    rng = np.random.RandomState(n)
    xyz = _f32(rng.randn(b, n, 3) * 0.1, cuda)
    assert torch.equal(ops.furthest_point_sample(xyz, npoint),
                       plain.furthest_point_sample(xyz, npoint))
    dup = _f32((rng.randn(b, 48, 3) * 0.1)[:, rng.randint(0, 48, n)], cuda)
    got = ops.furthest_point_sample(dup, 64)
    assert torch.equal(got, plain.furthest_point_sample(dup, 64))
    assert (got[:, 48:] == 0).all()       # every minimum 0: index 0 wins
    assert ops.launch_counts()["fps"] == 2


@pytest.mark.parametrize("n", [128, 1024, 2048])
def test_fps_kernel_ties(cuda, n):
    """Duplicated points (ties between copies go to the lower index) and a
    cloud whose minima are all equal (every pick is index 0)."""
    rng = np.random.RandomState(5)
    distinct = rng.randn(2, 24, 3) * 0.1
    xyz = _f32(distinct[:, rng.randint(0, 24, n)], cuda)
    got = ops.furthest_point_sample(xyz, 40)
    assert torch.equal(got, plain.furthest_point_sample(xyz, 40))
    assert (got[:, 24:] == 0).all()       # every minimum 0: index 0 wins
    same = torch.zeros(2, n, 3, device=cuda)
    assert torch.equal(ops.furthest_point_sample(same, 9),
                       torch.zeros(2, 9, dtype=torch.int32, device=cuda))


_BQG_RADII = [((0.1,), (1,)), ((0.05, 0.15), (16, 32)), ((0.1,), (64,)),
              ((0.08, 0.2), (64, 16))]
_BQG_DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
               (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("feat_dtype,out_dtype", _BQG_DTYPES)
@pytest.mark.parametrize("radii,nsamples", _BQG_RADII)
@pytest.mark.parametrize("cf", [0, 7, 64, 256, 600, 2000, 3000])
def test_ball_query_group_kernel_shapes(cuda, cf, radii, nsamples, feat_dtype,
                                        out_dtype):
    """C in {0, 7, 64, 256} (16-byte feature loads or scalar ones), 600
    (rows too wide for vector-store chunks in shared memory), 2000 (one row
    a chunk in bf16 output; in f32 the row does not fit a warp's buffer:
    the global-memory kernel) and 3000 (that kernel in both), ns in
    {1, 16, 32, 64} (vector or scalar stores, one chunk or several), one and
    two radii, centroids with no hit, B * M = 90 (no multiple of the 8
    centroids a block), every feature / output dtype pair: equal to the plain
    version (bf16 output: its f32 result cast once)."""
    rng = np.random.RandomState(cf + nsamples[0])
    xyz = _f32(rng.randn(2, 300, 3) * 0.1, cuda)
    cent = xyz[:, :45] + _f32(rng.randn(2, 45, 3) * 0.01, cuda)
    cent[1, :10] += 50.0                      # rows with no hit: point 0
    feats = _f32(rng.randn(2, 300, cf), cuda).to(feat_dtype) if cf else None
    args = (radii, nsamples, xyz, cent.contiguous(), feats)
    got = ops.ball_query_group(*args, out_dtype=out_dtype)
    want = plain.ball_query_group(*args, out_dtype)
    assert ops.launch_counts()["ball_query_group"] == 1
    for g, w in zip(got, want):
        assert g.dtype == out_dtype and torch.equal(g, w)


@pytest.mark.parametrize("n", [300, 2500])
@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
def test_ball_query_group_kernel_large_cloud_and_unaligned_features(
        cuda, feat_dtype, n):
    """N = 300 (the cloud staged in shared memory) and 2500 (too large to
    stage: the global-memory kernel), with a feature tensor whose data
    starts 8 bytes off a 16-byte boundary (scalar feature loads): still
    equal to the plain version."""
    rng = np.random.RandomState(12)
    xyz = _f32(rng.randn(2, n, 3) * 0.1, cuda)
    cent = xyz[:, :37].contiguous()
    flat = torch.zeros(2 * n * 64 + 8, device=cuda, dtype=feat_dtype)
    feats = flat[8 // flat.element_size():][:2 * n * 64].view(2, n, 64)
    feats.copy_(_f32(rng.randn(2, n, 64), cuda))
    assert feats.data_ptr() % 16 != 0
    for out_dtype in (torch.float32, torch.bfloat16):
        args = ((0.02, 0.05), (16, 32), xyz, cent, feats)
        for g, w in zip(ops.ball_query_group(*args, out_dtype=out_dtype),
                        plain.ball_query_group(*args, out_dtype)):
            assert torch.equal(g, w)


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
                                                    (2, 1, 4, 3, 5, True),
                                                    (1, 7, 9, 33, 12, True),
                                                    (3, 17, 5, 40, 193, False),
                                                    (1, 9, 11, 300, 64, True),
                                                    (1, 1, 1, 8, 8, True),
                                                    (1, 48, 48, 256, 64, True)])
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
    # the constants packed ahead give the same bits, launch after launch
    packed = fold_upsample.pack_fold(k, bias, ep)
    assert torch.equal(ops.fold_upsample_conv(x, packed), got)
    assert torch.equal(ops.fold_upsample_conv(x, k, bias, ep), got)


def test_wrappers_refuse_grad_requiring_inputs(cuda):
    """A raw kernel wrapper is forward-only: it records no graph, so with
    grad mode on it refuses an input that requires grad. The dispatch ops
    take such inputs: FPS gives indices and detaches its points."""
    xyz = torch.zeros(1, 64, 3, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        dispatch.wrapper("fps")(xyz, 8)
    with torch.no_grad():
        dispatch.wrapper("fps")(xyz, 8)
    idx = ops.furthest_point_sample(xyz, 8)
    assert not idx.requires_grad and ops.launch_counts()["fps"] == 2
    # the fused SA stage's folded weights count as inputs too
    pts = xyz.detach()
    feats = torch.zeros(1, 64, 8, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(11, 16, device=cuda, requires_grad=True)
    folded = [[(w, torch.zeros(16, device=cuda))]]
    with pytest.raises(RuntimeError, match="forward-only"):
        dispatch.wrapper("sa_fused")((0.1,), (16,), pts, pts[:, :8], feats,
                                     folded)
    with torch.no_grad():
        dispatch.wrapper("sa_fused")((0.1,), (16,), pts, pts[:, :8], feats,
                                     folded)
    assert ops.launch_counts()["sa_fused"] == 1


def test_dispatch_ops_are_differentiable_on_the_card(cuda):
    """The grouping and the FP interpolation on CUDA tensors run as
    autograd Functions whose backward passes are kernels (8 + the grouping
    scatter, 10 + the interpolation scatter); their gradients equal
    autograd through the plain ops on the CPU to 1e-5 (f32 atomics)."""
    rng = np.random.RandomState(7)
    xyz = rng.randn(2, 300, 3) * 0.1
    cent = xyz[:, :45] + rng.randn(2, 45, 3) * 0.01
    cent[1, :10] += 50.0                      # rows with no hit
    feats = rng.randn(2, 300, 9)
    cots = [rng.randn(2, 45, ns, 12) for ns in (16, 32)]

    def grads(device, op):
        ins = [_f32(a, device).requires_grad_() for a in (xyz, cent, feats)]
        outs = op((0.05, 0.15), (16, 32), *ins)
        torch.autograd.backward(outs, [_f32(c, device) for c in cots])
        return [t.grad.cpu() for t in ins]

    got = grads(cuda, ops.ball_query_group)
    want = grads("cpu", plain.ball_query_group)
    assert ops.launch_counts() == _counts(ball_query_group=1, ball_query=1,
                                          group_scatter=1)
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()

    unknown = rng.randn(2, 500, 3) * 0.1
    known = unknown[:, :70]                   # distances of exactly 0
    fp_feats = rng.randn(2, 70, 37)
    cot = rng.randn(2, 500, 37)

    def fp_grads(device, op):
        u, k = _f32(unknown, device), _f32(known, device)
        f = _f32(fp_feats, device).requires_grad_()
        op(u, k, f).backward(_f32(cot, device))
        return f.grad.cpu()

    g, w = fp_grads(cuda, ops.fp_interpolate), fp_grads("cpu",
                                                        plain.fp_interpolate)
    assert torch.isfinite(g).all()
    assert (g - w).abs().max() <= 1e-5 * w.abs().max()
    assert ops.launch_counts()["three_nn"] == 1
    assert ops.launch_counts()["interp_scatter"] == 1


def test_card_forward_matches_cpu_forward(cuda):
    model = build_model(sa_npoints=(32, 16, 8, 8), seed=2, device="cpu")
    inputs = make_inputs(2, 128, 48, seed=4, device="cpu")
    with torch.no_grad():
        want = model(inputs)
        model.to(cuda)
        ops.reset_launch_counts()
        got = model({k: v.to(cuda) for k, v in inputs.items()})
    assert ops.launch_counts() == _counts(fps=4, ball_query_group=4,
                                          fp_interpolate=4, fold_upsample=1,
                                          bn_eval=55)
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
    (64, 1, 8, (16, 32), (16, 32)),         # M = 1: half a two-centroid item
    (150, 33, 16, (40, 72), (1, 17)),       # ns 1 and 17: rows padded to 16, 32
    (90, 7, 3, (8, 8, 8, 8), (33, 64)),     # depth 4, 64-row items, two radii
    (128, 64, 256, (128, 128, 256), (16, 32)),  # SA stage 4's widths
    (700, 129, 24, (200,), (3,)),           # one wide layer, one radius
    (40, 5, 0, (5, 3), (2, 48)),            # C = 3, widths under one tile
])
@pytest.mark.parametrize("b", [2, 1])
def test_sa_fused_kernel(cuda, b, n, m, cf, channels, nsamples):
    rng = np.random.RandomState(n + m)
    xyz = _f32(rng.randn(b, n, 3) * 0.2, cuda)
    cent = _f32(rng.randn(b, m, 3) * 0.2, cuda)
    cent[b - 1, : m // 3] += 50.0             # rows with no hit
    feats = _bf16(rng.randn(b, n, cf), cuda) if cf else None
    radii = (0.15, 0.4)[:len(nsamples)]
    folded = [_folded(rng, 3 + cf, channels, cuda) for _ in nsamples]
    got = ops.sa_msg_fused(radii, nsamples, xyz, cent, feats, folded)
    want = sa_fused.plain(radii, nsamples, xyz, cent, feats, folded)
    assert ops.launch_counts()["sa_fused"] == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == (b, m, channels[-1])
        err = (g.float() - w.float()).abs().max().item()
        assert err <= 2e-2 * max(1.0, w.float().abs().max().item())
    # no atomics: the weights packed ahead, and a second launch, same bits
    packed = sa_fused.pack_folded(folded)
    again = ops.sa_msg_fused(radii, nsamples, xyz, cent, feats, packed)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    again = ops.sa_msg_fused(radii, nsamples, xyz, cent, feats, folded)
    assert all(torch.equal(g, a) for g, a in zip(got, again))


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
                                                    (2, 48, 48, 256, 64, True),
                                                    (2, 1, 4, 3, 5, True),
                                                    (1, 7, 9, 33, 12, True),
                                                    (3, 17, 5, 40, 193, False),
                                                    (1, 9, 11, 300, 64, True),
                                                    (2, 6, 6, 520, 16, True),
                                                    (1, 1, 1, 8, 8, True)])
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
    packed = fold_upsample.pack_fold(k, bias, ep)
    assert torch.equal(ops.fold_upsample_conv(x, packed), got)
    assert torch.equal(ops.fold_upsample_conv(x, k, bias, ep), got)


def test_card_bf16_forward_matches_cpu_bf16_forward(cuda):
    model = build_model(sa_npoints=(32, 16, 8, 8), seed=2, device="cpu")
    inputs = make_inputs(2, 128, 48, seed=4, device="cpu")
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
    assert ops.launch_counts() == _counts(fps=4, ball_query_group=1,
                                          fp_interpolate=4, fold_upsample=1,
                                          sa_fused=3, bn_eval=37)
    # measured <= 8.7e-4 (cuDNN and cuBLAS round bf16 after other sums)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=5e-3)


# ---------------------------------------------------------------------------
# The eval BatchNorm pass (BN and its consumer in one launch)
# ---------------------------------------------------------------------------

def _bits(t):
    return t.contiguous().view(torch.int16 if t.element_size() == 2
                               else torch.int32)


def _same_bits(got, want) -> bool:
    return (got.dtype == want.dtype and got.shape == want.shape
            and torch.equal(_bits(got), _bits(want)))


def _bn_sites(model, inputs, monkeypatch) -> list:
    """The argument tuples of every eval BN pass of one forward."""
    sites, real = [], dispatch.bn_eval

    def record(*args):
        sites.append(args)
        return real(*args)

    with monkeypatch.context() as m:
        m.setattr(dispatch, "bn_eval", record)
        with torch.inference_mode():
            model(inputs)
    return sites


@pytest.mark.parametrize("dtype,batch", [(torch.bfloat16, 32),
                                         (torch.bfloat16, 128),
                                         (torch.float32, 32)],
                         ids=["bf16-B32", "bf16-B128", "f32-B32"])
def test_bn_eval_kernel_at_every_call_site_of_the_forward(cuda, dtype, batch,
                                                          monkeypatch):
    """Each eval BN pass of a full-width forward (the maps, statistics,
    residuals and slopes the forward hands it, up_1's permuted map
    included) through the kernel and through the plain version: the same
    bits, the output in x's layout."""
    model = build_model(cuda, seed=11)
    inputs = make_inputs(batch, 1024, seed=12, device=cuda)
    old = precision.compute_dtype()
    precision.set_compute_dtype(dtype)
    try:
        sites = _bn_sites(model, inputs, monkeypatch)
    finally:
        precision.set_compute_dtype(old)
    assert len(sites) == _eval_bns(model, dtype)
    kern = dispatch.wrapper("bn_eval")
    with torch.inference_mode():
        for args in sites:
            got, want = kern(*args), bn_eval.plain(*args)
            assert got.stride() == args[0].stride()
            assert _same_bits(got, want), (tuple(args[0].shape), args[2],
                                           args[3] is not None)


def _edge_values(rng, shape, dtype, device):
    """Normal values with NaN, +-inf, -0.0 and 0.0 sprinkled in."""
    a = (rng.randn(*shape) * 3).astype(np.float32)
    flat = a.reshape(-1)
    picks = rng.choice(flat.size, size=min(flat.size, 40), replace=False)
    flat[picks] = np.resize(np.array([np.nan, np.inf, -np.inf, -0.0, 0.0],
                                     np.float32), picks.size)
    return _f32(a, device).to(dtype)


def _laid_out(t, layout):
    """``t`` as a contiguous map, a view 2 or 4 bytes off a 16-byte
    boundary, or a map whose outer axes are permuted in memory."""
    if layout == "misaligned":
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view
    if layout in ("permuted", "mixed"):
        return t.permute(2, 0, 1, 3).contiguous().permute(1, 2, 0, 3)
    return t


@pytest.mark.parametrize("layout", ["contiguous", "misaligned", "permuted",
                                    "mixed"])
@pytest.mark.parametrize("c", [3, 24, 64, 130, 2056])
@pytest.mark.parametrize("act", ["none", "relu", "add_relu", "prelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_eval_kernel_edges(cuda, dtype, act, c, layout):
    """The kernel against the plain version bit for bit on NaN, +-inf and
    +-0.0 in the map, the residual and the bias, for channel counts off the
    vector width (3, 130: the scalar kernel), with rows of vectors that do
    not divide the block (24, 2056), on views off a 16-byte boundary and on
    permuted maps (a residual laid out otherwise: "mixed")."""
    rng = np.random.RandomState(c)
    shape = (2, 5, 7, c)
    x = _laid_out(_edge_values(rng, shape, dtype, cuda), layout)
    rows = torch.stack([_f32(rng.randn(c), cuda),
                        torch.rsqrt(_f32(rng.rand(c), cuda) + 1e-5),
                        _f32(rng.randn(c), cuda), _f32(rng.randn(c), cuda)])
    rows[3, ::5] = -0.0
    rows[2, 1::7] = 0.0
    residual = slope = None
    name = {"none": None, "add_relu": "relu"}.get(act, act)
    if act == "add_relu":
        residual = _edge_values(rng, shape, dtype, cuda)
        residual = residual if layout == "mixed" else _laid_out(residual,
                                                                layout)
    if act == "prelu":
        slope = _f32([0.2371], cuda)
    args = (x, rows, name, residual, slope)
    with torch.inference_mode():
        got = dispatch.wrapper("bn_eval")(*args)
        want = bn_eval.plain(*args)
    assert _same_bits(got, want)
    assert ops.launch_counts()["bn_eval"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_forward_is_bit_equal_to_the_plain_bn_pass(cuda, dtype,
                                                        monkeypatch):
    """The whole B=32 eval forward (sparse head) with the eval BN pass on
    the card against the same forward with the pass's plain version: every
    output equal in its bits; the pass launched once for each BN outside
    kernels 4 and 5."""
    model = build_model(cuda, seed=13)
    inputs = make_inputs(32, 1024, seed=14, device=cuda)
    old = precision.compute_dtype()
    precision.set_compute_dtype(dtype)
    try:
        with torch.inference_mode():
            got = model(inputs)
            launched = ops.launch_counts()["bn_eval"]
            monkeypatch.setattr(dispatch, "bn_eval", bn_eval.plain)
            want = model(inputs)
    finally:
        precision.set_compute_dtype(old)
    assert launched == _eval_bns(model, dtype) == {torch.float32: 55,
                                                   torch.bfloat16: 37}[dtype]
    assert ops.launch_counts()["bn_eval"] == launched
    for k in want:
        assert _same_bits(got[k], want[k]), k


def test_bn_eval_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(2, 8, device=cuda)
    rows = torch.zeros(4, 8, device=cuda)
    kern = dispatch.wrapper("bn_eval")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kern(x.double(), rows)
    with pytest.raises(ValueError, match="rows"):
        kern(x, rows[:, :4])
    with pytest.raises(ValueError, match="residual"):
        kern(x, rows, "prelu", x, torch.ones(1, device=cuda))
    with pytest.raises(ValueError, match="slope"):
        kern(x, rows, "prelu")
    with pytest.raises(RuntimeError, match="forward-only"):
        kern(x.requires_grad_(), rows)
    assert ops.launch_counts()["bn_eval"] == 0


# ---------------------------------------------------------------------------
# float32 training: the backward kernels and one train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,m,radii,nsamples", [
    (512, 256, (0.02, 0.04), (16, 32)),     # SA stage 2, camera radii
    (300, 45, (0.1,), (64,)),               # ragged, one radius, ns 64
])
def test_ball_query_kernel(cuda, n, m, radii, nsamples):
    rng = np.random.RandomState(8)
    xyz = _f32(rng.randn(2, n, 3) * 0.1, cuda)
    cent = xyz[:, :m].clone()
    cent[1, : m // 4] += 50.0                 # rows with no hit: point 0
    got = dispatch.wrapper("ball_query")(radii, nsamples, xyz, cent)
    want = plain.ball_query_multi(radii, nsamples, xyz, cent)
    assert ops.launch_counts()["ball_query"] == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)


def _same_lists_as_the_grouping(radii, nsamples, xyz, cent, idx_list):
    """Kernel 2's grouped xyz on these inputs are the rows of idx_list: the
    forward's lists and the backward's recomputed ones are the same."""
    grouped = dispatch.wrapper("ball_query_group")(radii, nsamples, xyz, cent,
                                                   None)
    return all(torch.equal(g, plain.group_points(xyz, i) - cent[:, :, None])
               for g, i in zip(grouped, idx_list))


def _cloud(seed, b, n, m, scale=0.1):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(b, n, 3) * scale
    return xyz, xyz[:, :m].copy()


def _bq_no_hit(cuda):
    xyz, cent = _cloud(20, 2, 300, 45)
    cent[:, :, 0] += 50.0                       # every centroid far away
    return (0.05,), (64,), xyz, cent


_BQ_CASES = {
    # SA 1's shapes (M=512, the camera radii) at N=2048: a staged cloud of
    # 32 KB
    "n2048_sa1": lambda cuda: ((0.01, 0.02), (16, 32),
                               *_cloud(21, 2, 2048, 512)),
    # past the staged limit (N > 2816): the scan from device memory
    "n3000_element_wise": lambda cuda: ((0.02, 0.05), (16, 32),
                                        *_cloud(22, 2, 3000, 100)),
    "radius_with_no_hit": _bq_no_hit,
    # a cloud of 1 cm: every list full within the first 32-point chunk
    "lists_full_in_the_first_chunk": lambda cuda: (
        (0.5, 1.0), (16, 32), *_cloud(23, 2, 300, 45, 0.01)),
    # B * M / 8 = 1280 blocks, more than the card holds at once
    "many_blocks": lambda cuda: ((0.02, 0.04), (16, 32),
                                 *_cloud(24, 40, 512, 256)),
}


@pytest.mark.parametrize("case", sorted(_BQ_CASES))
def test_ball_query_kernel_staging_and_scan_edges(cuda, case):
    """Kernel 8 equal to the plain version and to kernel 2's lists: a
    staged cloud at SA 1's width, one too large to stage, a radius no point
    is in (every slot point 0), lists full in the first chunk, a grid of
    several waves."""
    radii, nsamples, xyz, cent = _BQ_CASES[case](cuda)
    xyz, cent = _f32(xyz, cuda), _f32(cent, cuda)
    got = dispatch.wrapper("ball_query")(radii, nsamples, xyz, cent)
    want = plain.ball_query_multi(radii, nsamples, xyz, cent)
    assert ops.launch_counts()["ball_query"] == 1
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    assert _same_lists_as_the_grouping(radii, nsamples, xyz, cent, got)
    if case == "radius_with_no_hit":
        assert (got[0] == 0).all()


@pytest.mark.parametrize("n,m,cf", [(256, 128, 128), (300, 45, 6)])
def test_group_scatter_kernel(cuda, n, m, cf):
    rng = np.random.RandomState(9)
    xyz = _f32(rng.randn(2, n, 3) * 0.1, cuda)
    cent = xyz[:, :m].clone()
    cent[0, :5] += 50.0
    idx = plain.ball_query_multi((0.04, 0.08), (16, 32), xyz, cent)
    grads = [_f32(rng.randn(2, m, ns, 3 + cf), cuda) for ns in (16, 32)]
    got = dispatch.wrapper("group_scatter")(idx, grads, n)
    want = plain.group_scatter(idx, grads, n)
    for g, w in zip(got, want):               # points_bar, centroid_bar
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert (g - w).abs().max() <= 1e-5 * w.abs().max()


@pytest.mark.parametrize("n,m", [(1024, 512), (500, 70), (128, 4000)])
def test_three_nn_kernel(cuda, n, m):
    rng = np.random.RandomState(10)
    unknown = _f32(rng.randn(2, n, 3) * 0.1, cuda)
    known = (unknown[:, :m].contiguous() if m <= n
             else _f32(rng.randn(2, m, 3) * 0.1, cuda))
    dist, idx = dispatch.wrapper("three_nn")(unknown, known)
    w_dist, w_idx = plain.three_nn(unknown, known)
    assert torch.equal(idx, w_idx) and torch.equal(dist, w_dist)


def _fp_stage(seed, b, n, m, device):
    """An FP stage's points: ``n`` unknown ones and ``m`` known ones drawn
    from them (an FP stage's known points are the stage below's FPS
    picks: distances of exactly 0), or new ones where ``m > n``."""
    rng = np.random.RandomState(seed)
    unknown = _f32(rng.randn(b, n, 3) * 0.1, device)
    if m > n:
        return unknown, _f32(rng.randn(b, m, 3) * 0.1, device)
    pick = torch.from_numpy(rng.permutation(n)[:m]).to(device)
    return unknown, unknown[:, pick].contiguous()


def _check_three_nn(unknown, known):
    """Both variants of kernel 10 against the plain version: distances and
    indices equal; the weights within 2 ulp of ``three_interpolate_weights``
    of the plain distances (float32 sums of 3 in another order)."""
    kern = dispatch.wrapper("three_nn")
    w_dist, w_idx = plain.three_nn(unknown, known)
    dist, idx = kern(unknown, known)
    assert dist.dtype == torch.float32 and idx.dtype == torch.int32
    assert torch.equal(idx, w_idx) and torch.equal(dist, w_dist)
    weight, idx_w = kern(unknown, known, weights=True)
    want = plain.three_interpolate_weights(w_dist)
    ulp = torch.nextafter(want.abs(), torch.full_like(want, np.inf)) \
        - want.abs()
    assert torch.equal(idx_w, w_idx)
    assert ((weight - want).abs() <= 2 * ulp).all()


@pytest.mark.parametrize("b", [32, 8, 24])
@pytest.mark.parametrize("n,m", [(128, 64), (256, 128), (512, 256),
                                 (1024, 512), (2048, 512), (2048, 1024)])
def test_three_nn_kernel_path_shapes(cuda, b, n, m):
    """FP 1-4 of the eval forward (B=32), the serving bucket (8) and the
    train step (24), and FP 4 of 2048-point clouds (SA 1 at 512 or 1024
    points)."""
    _check_three_nn(*_fp_stage(13, b, n, m, cuda))


@pytest.mark.parametrize("n,m", [(500, 3), (64, 5), (777, 37), (129, 1023),
                                 (300, 8192), (1000, 8191), (1, 4)])
def test_three_nn_kernel_known_set_sizes(cuda, n, m):
    """The smallest known set, sizes that are no multiple of the group or
    of the unrolled step, the largest that shared memory holds, one
    unknown point."""
    _check_three_nn(*_fp_stage(14, 2, n, m, cuda))


@pytest.mark.parametrize("case", ["duplicates", "grid"])
def test_three_nn_kernel_ties(cuda, case):
    """Equal distances: known points duplicated in the cloud (the unknown
    ones among them, so ties at distance 0), and points on a coarse grid,
    exact in float32, where many distances are equal."""
    rng = np.random.RandomState(15)
    if case == "duplicates":
        base = rng.randn(2, 90, 3) * 0.1
        known = np.concatenate([base, base[:, ::-1], base[:, :7]], axis=1)
        known = known[:, rng.permutation(known.shape[1])]
        unknown = np.concatenate([base, rng.randn(2, 50, 3) * 0.1], axis=1)
    else:
        known = rng.randint(-3, 4, size=(2, 300, 3)) * 0.25
        unknown = rng.randint(-3, 4, size=(2, 400, 3)) * 0.125
    _check_three_nn(_f32(unknown, cuda), _f32(known, cuda))


def _check_fp(unknown, known, feats):
    got = ops.fp_interpolate(unknown, known, feats)
    want = plain.fp_interpolate(unknown, known, feats)
    tol = 2.0 ** -8 if feats.dtype == torch.bfloat16 else 1e-5
    assert got.dtype == feats.dtype and got.shape == want.shape
    assert ((got.float() - want.float()).abs().max()
            <= tol * want.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [37, 125, 256, 512, 517])
def test_fp_interpolate_kernel_widths(cuda, c, dtype):
    """Rows of 16-byte vectors (C = 256, 512) and rows that take the scalar
    instance (C = 37, 125, 517), against the plain version within 1e-5
    (float32) or 2^-8 (bf16) of the largest value."""
    unknown, known = _fp_stage(16, 3, 700, 300, cuda)
    rng = np.random.RandomState(c)
    _check_fp(unknown, known, _f32(rng.randn(3, 300, c), cuda).to(dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fp_interpolate_kernel_features_off_a_16_byte_boundary(cuda, dtype):
    """Features that start off a 16-byte boundary (8 bytes for float32, 4
    for bf16) take the scalar instance and give the same values as the
    aligned copy."""
    unknown, known = _fp_stage(17, 2, 300, 100, cuda)
    rng = np.random.RandomState(18)
    flat = _f32(rng.randn(2 * 100 * 64 + 2), cuda).to(dtype)
    feats = flat[2:].view(2, 100, 64)
    assert feats.data_ptr() % 16 != 0
    _check_fp(unknown, known, feats)
    assert torch.equal(ops.fp_interpolate(unknown, known, feats),
                       ops.fp_interpolate(unknown, known, feats.clone()))


@pytest.mark.parametrize("b,n,m,c", [(32, 128, 64, 512), (8, 1024, 512, 256),
                                     (24, 512, 256, 256), (2, 2048, 1024, 64),
                                     (2, 777, 3, 16), (2, 100, 8192, 8)])
def test_fp_interpolate_kernel_shapes(cuda, b, n, m, c):
    unknown, known = _fp_stage(19, b, n, m, cuda)
    rng = np.random.RandomState(20)
    feats = rng.randn(b, m, c)
    for dtype in (torch.float32, torch.bfloat16):
        _check_fp(unknown, known, _f32(feats, cuda).to(dtype))


def test_fp_interpolate_bf16_cotangent_gradient(cuda):
    """``FPInterpolate`` with bf16 features and a bf16 cotangent: the
    gradient is bf16 and equals autograd through the plain op on the same
    card to 2^-7 of its largest value (both sum in float32 and round once
    to bf16, in another order: one bf16 ulp apart at most)."""
    unknown, known = _fp_stage(21, 4, 512, 256, cuda)
    rng = np.random.RandomState(22)
    feats = _f32(rng.randn(4, 256, 131), cuda).to(torch.bfloat16)
    cot = _f32(rng.randn(4, 512, 131), cuda).to(torch.bfloat16)

    def grad(op):
        f = feats.clone().requires_grad_()
        op(unknown, known, f).backward(cot)
        return f.grad

    got, want = grad(ops.fp_interpolate), grad(plain.fp_interpolate)
    assert ops.launch_counts()["three_nn"] == 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert ((got.float() - want.float()).abs().max()
            <= 2.0 ** -7 * want.float().abs().max())


@pytest.mark.parametrize("with_features", [False, True])
def test_ball_query_group_bf16_cotangent_gradient(cuda, with_features):
    """``BallQueryGroup`` with bf16 outputs and cotangents: the points' and
    centroids' gradients are float32 and equal autograd through the plain
    op on the same card to 1e-5 of their largest value (float32 sums of
    exact bf16 values in another order); the bf16 features' gradient to
    2^-6 (the plain op rounds each radius's sum to bf16 and their sum
    again, the kernel rounds the float32 total once: two bf16 ulps)."""
    rng = np.random.RandomState(23)
    xyz = rng.randn(2, 512, 3) * 0.1
    cent = xyz[:, :256] + rng.randn(2, 256, 3) * 0.01
    cf = 64 if with_features else 0
    feats = rng.randn(2, 512, cf)
    cots = [_f32(rng.randn(2, 256, ns, 3 + cf), cuda).to(torch.bfloat16)
            for ns in (16, 32)]

    def grads(op):
        ins = [_f32(xyz, cuda).requires_grad_(),
               _f32(cent, cuda).requires_grad_()]
        f = (_f32(feats, cuda).to(torch.bfloat16).requires_grad_()
             if with_features else None)
        outs = op((0.02, 0.04), (16, 32), *ins, f, torch.bfloat16)
        torch.autograd.backward(outs, cots)
        return [t.grad for t in ins] + ([f.grad] if with_features else [])

    got, want = grads(ops.ball_query_group), grads(plain.ball_query_group)
    assert ops.launch_counts()["group_scatter"] == 1
    for g, w, tol in zip(got, want, (1e-5, 1e-5, 2.0 ** -6)):
        assert g.dtype == w.dtype
        err = (g.float() - w.float()).abs().max()
        assert err <= tol * w.float().abs().max()


@pytest.mark.parametrize("n,m,c", [(1024, 512, 256), (500, 70, 37)])
def test_interp_scatter_kernel(cuda, n, m, c):
    rng = np.random.RandomState(11)
    unknown = _f32(rng.randn(2, n, 3) * 0.1, cuda)
    dist, idx = plain.three_nn(unknown, unknown[:, :m].contiguous())
    weight = plain.three_interpolate_weights(dist)
    grad = _f32(rng.randn(2, n, c), cuda)
    got = dispatch.wrapper("interp_scatter")(grad, idx, weight, m)
    want = plain.three_interpolate_grad(grad, idx, weight, m)
    assert got.shape == (2, m, c)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _close(got, want):
    """A scatter's output against its plain version: dtype, shape, 1e-5 of
    the largest value."""
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def _group_scatter_case(cuda, seed, b, n, m, cf, dtype, radii=(0.04, 0.08),
                        one_point=None):
    """Index maps of the ball query (centroids among the points, a few far
    away without a hit) or, with ``one_point``, that point in every slot;
    cotangents of ``dtype``."""
    rng = np.random.RandomState(seed)
    xyz = _f32(rng.randn(b, n, 3) * 0.1, cuda)
    cent = xyz[:, torch.from_numpy(rng.randint(0, n, m)).to(cuda)].clone()
    cent[0, :5] += 50.0
    idx = plain.ball_query_multi(radii, (16, 32), xyz, cent)
    if one_point is not None:
        idx = [torch.full_like(i, one_point) for i in idx]
    grads = [_f32(rng.randn(b, m, ns, 3 + cf), cuda).to(dtype)
             for ns in (16, 32)]
    return idx, grads


def _check_group_scatter(idx, grads, n):
    kern = dispatch.wrapper("group_scatter")
    got = kern(idx, grads, n)
    again = kern(idx, grads, n)
    want = plain.group_scatter(idx, grads, n)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):      # points_bar, centroid_bar
        _close(g, w)
        assert torch.equal(g, a)               # the same bits, call to call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,cf", [(512, 256, 64), (256, 128, 128),
                                    (128, 64, 256)],
                         ids=["sa2", "sa3", "sa4"])
def test_group_scatter_kernel_path_shapes(cuda, n, m, cf, dtype):
    """SA stages 2-4 (3 + C = 67, 131, 259), B=3."""
    idx, grads = _group_scatter_case(cuda, 12, 3, n, m, cf, dtype)
    _check_group_scatter(idx, grads, n)
    assert ops.launch_counts()["group_scatter"] == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("point", [0, 77])
def test_group_scatter_kernel_one_point_in_every_ball(cuda, point, dtype):
    """Every slot names one point: its list is every slot of the sample
    (12,288 rows at SA stage 2's shape), cut into chunks whose partial
    sums meet; every other point gets zeros."""
    idx, grads = _group_scatter_case(cuda, 13, 2, 512, 256, 64, dtype,
                                     one_point=point)
    _check_group_scatter(idx, grads, 512)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,cf,radii", [(2500, 4000, 7, (0.01, 0.03)),
                                          (2500, 300, 600, (0.02, 0.05))])
def test_group_scatter_kernel_large_cloud(cuda, n, m, cf, radii, dtype):
    """N = 2500 points: histograms too large for shared memory take the
    workspace; M = 4000 centroids; a wide row (3 + C = 603)."""
    idx, grads = _group_scatter_case(cuda, 14, 2, n, m, cf, dtype, radii)
    _check_group_scatter(idx, grads, n)


def _check_interp_scatter(grad, idx, weight, m):
    kern = dispatch.wrapper("interp_scatter")
    got, again = kern(grad, idx, weight, m), kern(grad, idx, weight, m)
    want = plain.three_interpolate_grad(grad, idx, weight, m)
    torch.cuda.synchronize()
    _close(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [125, 127, 253, 509, 517])
def test_interp_scatter_kernel_widths_at_a_vector_seam(cuda, c, dtype):
    """Rows that are not 16-byte aligned and end within 3 values of a
    warp's 128 channels, a slice's 512, or just past them: the values that
    lane 31 takes from the vector after its last."""
    rng = np.random.RandomState(20)
    unknown = _f32(rng.randn(2, 90, 3) * 0.1, cuda)
    dist, idx = plain.three_nn(unknown, unknown[:, :40].contiguous())
    weight = plain.three_interpolate_weights(dist)
    grad = _f32(rng.randn(2, 90, c), cuda).to(dtype)
    _check_interp_scatter(grad, idx, weight, 40)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,m,c", [(128, 64, 512), (256, 128, 512),
                                   (512, 256, 256), (1024, 512, 256),
                                   (2500, 4000, 37), (4000, 2500, 300)],
                         ids=["fp1", "fp2", "fp3", "fp4", "m4000", "n4000"])
def test_interp_scatter_kernel_shapes(cuda, n, m, c, dtype):
    """FP stages 1-4 in call order, the known set part of the unknown one
    (distances of 0); M = 4000 known points (histograms in the workspace,
    most rows empty) and N = 4000 unknown ones; B=3."""
    rng = np.random.RandomState(15)
    unknown = _f32(rng.randn(3, n, 3) * 0.1, cuda)
    known = (unknown[:, :m].contiguous() if m <= n
             else _f32(rng.randn(3, m, 3) * 0.1, cuda))
    dist, idx = plain.three_nn(unknown, known)
    weight = plain.three_interpolate_weights(dist)
    grad = _f32(rng.randn(3, n, c), cuda).to(dtype)
    _check_interp_scatter(grad, idx, weight, m)
    assert ops.launch_counts()["interp_scatter"] == 2


def test_scatters_take_cotangents_off_a_16_byte_boundary(cuda):
    """A cotangent that is a view starting 4 bytes into its storage (the
    kernels read rows as aligned vectors: the wrappers copy it first)."""
    rng = np.random.RandomState(18)
    unknown = _f32(rng.randn(2, 300, 3) * 0.1, cuda)
    dist, idx = plain.three_nn(unknown, unknown[:, :70].contiguous())
    weight = plain.three_interpolate_weights(dist)
    flat = _f32(rng.randn(2 * 300 * 37 + 1), cuda)
    grad = flat[1:].view(2, 300, 37)
    assert grad.data_ptr() % 16 != 0
    _check_interp_scatter(grad, idx, weight, 70)
    idx_g, grads = _group_scatter_case(cuda, 19, 2, 300, 45, 6, torch.float32)
    shifted = []
    for g in grads:
        f = torch.empty(g.numel() + 1, device=cuda)
        f[1:] = g.reshape(-1)
        shifted.append(f[1:].view(g.shape))
    _check_group_scatter(idx_g, shifted, 300)


def test_interp_scatter_kernel_one_known_point(cuda):
    """Every neighbour is known point 3: one list of all 3 N pairs."""
    rng = np.random.RandomState(16)
    idx = torch.full((2, 1024, 3), 3, dtype=torch.int32, device=cuda)
    weight = _f32(rng.rand(2, 1024, 3), cuda)
    grad = _f32(rng.randn(2, 1024, 256), cuda)
    _check_interp_scatter(grad, idx, weight, 512)


@pytest.mark.parametrize("case", ["sa2", "fp4", "one_point", "rows2500",
                                  "rows4000", "empty"])
def test_invert_index_kernel(cuda, case):
    """The inversion the scatters run, alone, equal to its plain version:
    SA stage 2's maps with rows without a hit and pad slots, FP stage 4's,
    one point named by every entry, histograms in the workspace (2,500 and
    4,000 rows), no entry at all."""
    rng = np.random.RandomState(17)
    if case == "sa2":
        idx, _ = _group_scatter_case(cuda, 12, 3, 512, 256, 64, torch.float32)
        keys, rows = torch.cat([i.reshape(3, -1) for i in idx], 1), 512
    elif case == "fp4":
        unknown = _f32(rng.randn(3, 1024, 3) * 0.1, cuda)
        _, idx = plain.three_nn(unknown, unknown[:, :512].contiguous())
        keys, rows = idx.reshape(3, -1), 512
    elif case == "one_point":
        keys, rows = torch.full((2, 12288), 9, dtype=torch.int32,
                                device=cuda), 512
    elif case in ("rows2500", "rows4000"):
        rows = 2500 if case == "rows2500" else 4000
        keys = torch.from_numpy(rng.randint(0, rows, (2, 4000 * 48))
                                .astype(np.int32)).to(cuda)
    else:
        keys, rows = torch.zeros(2, 0, dtype=torch.int32, device=cuda), 64
    got = scatter_invert.invert_index_cuda(keys, rows)
    want = scatter_invert.plain(keys, rows)
    for g, w in zip(got, want):               # order, offsets
        assert g.dtype == torch.int32 and torch.equal(g, w)


def test_card_train_step_matches_cpu_train_step(cuda):
    """One default-recipe step, dropout off, B=2, N=128 (points at std 3 cm,
    so that the camera radii find neighbours), 48x48: the loss parts and
    the gradients on the card against the port's CPU step, as chip_smoke.py
    holds them on an H100: loss parts to 1e-5 relative (measured 1.2e-7);
    gradients to 1e-3 of the largest over all (9.2e-5), and per tensor to
    0.1 of the tensor's largest (measured <= 2.6e-2) for every tensor whose
    largest gradient is above 1e-5 of the largest of all (below it sit
    gradients of rounding noise and sums that cancel)."""
    cfg = TrainConfig()
    batch = make_train_batch(2, 128, 48, seed=5, device="cpu")
    batch["inputs"]["pts"] = batch["inputs"]["pts"] * 0.3
    runs, init = [], None
    for device in ("cpu", cuda):
        model = build_train_model(device, seed=3, sa_npoints=(32, 16, 8, 8))
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        for m in model.modules():
            if isinstance(m, layers.Dropout2d):
                m.eval()
        ops.reset_launch_counts()
        b = {part: {k: v.to(device) for k, v in d.items()}
             for part, d in batch.items()}
        parts = train_step(model, make_optimizer(model, cfg), b, 0,
                           torch.Generator(device=device), cfg)
        runs.append(({k: float(v) for k, v in parts.items()},
                     {k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None}))
    assert ops.launch_counts() == _counts(
        fps=8, ball_query_group=8, fp_interpolate=8, ball_query=6,
        group_scatter=6, three_nn=8, interp_scatter=8)
    (l_cpu, g_cpu), (l_gpu, g_gpu) = runs
    for k, v in l_cpu.items():
        assert abs(l_gpu[k] - v) <= 1e-5 * abs(v), k
    assert set(g_cpu) == set(g_gpu)
    scale = max(g.abs().max() for g in g_cpu.values())
    err = max((g_gpu[k] - g).abs().max() for k, g in g_cpu.items())
    assert err <= 1e-3 * scale
    for k, g in g_cpu.items():
        top = g.abs().max()
        if top > 1e-5 * scale:
            assert (g_gpu[k] - g).abs().max() <= 0.1 * top, k


def _holey_depth(seed, b, h, w):
    rng = np.random.RandomState(seed)
    d = rng.uniform(0.3, 2.8, size=(b, h, w)).astype(np.float32)
    d[rng.rand(b, h, w) < 0.35] = 0.0           # holes
    d[:, : h // 5] = 0.0                        # empty band at the top
    d[0, :, : w // 8] = 0.0                     # empty columns
    return d


@pytest.mark.parametrize("shape", [(1, 480, 640), (24, 480, 640), (2, 48, 128),
                                   (2, 37, 150), (3, 100, 333), (1, 5, 5),
                                   (1, 33, 5)])
def test_depth_fill_kernel(cuda, shape):
    """Kernel 11 against its plain version: the max/min/median chain equal,
    the bilateral's exp, products and divide within 1e-5 m."""
    from istnet_tpu_torch.ops import depth_fill

    depth = _f32(_holey_depth(shape[1], *shape), cuda)
    got = dispatch.wrapper("depth_fill")(depth, 3.0, bilateral=False)
    assert torch.equal(got, depth_fill.plain(depth, 3.0, bilateral=False))
    got = ops.fill_in_multiscale(depth)
    want = depth_fill.plain(depth)
    assert torch.equal(got > 0.01, want > 0.01)
    assert (got - want).abs().max().item() <= 1e-5
    assert ops.launch_counts() == _counts(depth_fill=2)


def _seam_frames(shape):
    return _holey_depth(shape[1] + shape[2], *shape)


def _batch_of_top_rows(shape):
    """24 images whose first valid rows differ in the same columns, so each
    image's top masks are its own."""
    d = _holey_depth(7, *shape)
    for i in range(shape[0]):
        d[i, : 3 * i] = 0.0
        d[i, :, 40 + 5 * i: 44 + 5 * i] = 0.0
        d[i, 10 * i + 1:, 290 + i] = 0.0
    return d


def _edge_columns(shape):
    """A column whose only valid pixel is in the last row, an all-empty
    column and an empty band of columns."""
    d = _holey_depth(8, *shape)
    d[:, :, 17] = 0.0
    d[:, -1, 17] = 0.8
    d[:, :, 70] = 0.0
    d[1, :, 100:130] = 0.0
    return d


_FILL_CASES = {
    # tile seams of the 40 x 64 and 40 x 60 tiles, H and W no multiples
    "seams_81x125": (_seam_frames, (2, 81, 125)),
    "seams_97x181": (_seam_frames, (1, 97, 181)),
    "seams_41x61": (_seam_frames, (2, 41, 61)),
    "seams_40x64": (_seam_frames, (1, 40, 64)),
    "seams_5x5": (_seam_frames, (3, 5, 5)),
    "batch_of_24_top_rows": (_batch_of_top_rows, (24, 96, 320)),
    "edge_columns": (_edge_columns, (2, 70, 150)),
    "all_zero": (lambda shape: np.zeros(shape, np.float32), (2, 70, 130)),
}


@pytest.mark.parametrize("case", sorted(_FILL_CASES))
def test_depth_fill_kernel_tiles_and_top_masks(cuda, case):
    """Kernel 11 bit-equal to its plain version without the bilateral at
    its tile seams and on the inputs that set the top masks."""
    from istnet_tpu_torch.ops import depth_fill

    make, shape = _FILL_CASES[case]
    depth = _f32(make(shape), cuda)
    got = dispatch.wrapper("depth_fill")(depth, 3.0, bilateral=False)
    assert torch.equal(got, depth_fill.plain(depth, 3.0, bilateral=False))
    assert ops.launch_counts() == _counts(depth_fill=1)


def test_depth_fill_kernel_all_zero_and_refusals(cuda):
    assert ops.fill_in_multiscale(
        torch.zeros(2, 480, 640, device=cuda)).abs().max().item() == 0.0
    with pytest.raises(ValueError):
        ops.fill_in_multiscale(torch.zeros(1, 4, 640, device=cuda))
    with pytest.raises(TypeError):
        dispatch.wrapper("depth_fill")(
            torch.zeros(1, 8, 8, device=cuda, dtype=torch.float64))


def test_device_forward_runs_over_padded_and_near_empty_rows(cuda):
    """A bucket whose padding rows have empty masks and an instance with 9
    valid pixels: no index leaves its range on the card, and the card's
    preprocessing equals the CPU's given the same uniforms."""
    from istnet_tpu_torch.data.device_preprocess import (
        fill_missing,
        preprocess_shared_image,
    )
    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
    from istnet_tpu_torch.entry import build_device_forward, make_frame
    from istnet_tpu_torch.eval.test_loop import _pad_chunk

    fr = make_frame(2, 5, n_tiny=1)
    masks, bboxes, category = _pad_chunk(fr["masks"], fr["bboxes"],
                                         fr["category_label"], 8)
    v = torch.rand(8, 128, generator=torch.Generator().manual_seed(1))
    pre = {}
    for dev in ("cpu", cuda):
        filled = fill_missing(
            torch.from_numpy(fr["depth_raw"])[None].to(dev))[0]
        out = preprocess_shared_image(
            torch.from_numpy(fr["rgb_full"]).to(dev), filled,
            torch.from_numpy(masks).to(dev), torch.from_numpy(bboxes).to(dev),
            torch.tensor(REAL_INTRINSICS), img_size=48, sample_num=128, v=v)
        pre[str(dev)] = {k: t.cpu() for k, t in out.items()}
    a, b = pre["cpu"], pre[str(cuda)]
    assert a["n_valid"].tolist()[4:] == [9, 0, 0, 0]
    for name in ("n_valid", "choose", "flat_idx"):
        assert torch.equal(a[name], b[name]), name
    assert (a["pts"][:5] - b["pts"][:5]).abs().max().item() <= 1e-5
    assert (a["rgb"] - b["rgb"]).abs().max().item() <= 1e-5

    ops.reset_launch_counts()
    _, fn = build_device_forward(torch.float32, cuda, 0, (32, 16, 8, 8), 48,
                                 128)
    out, n_valid = fn(fr["rgb_full"], fr["depth_raw"], masks, bboxes,
                      category, torch.Generator(device=cuda).manual_seed(0))
    torch.cuda.synchronize()
    assert n_valid.tolist()[4:] == [9, 0, 0, 0]
    for name, t in out.items():
        assert t.shape[0] == 8 and torch.isfinite(t).all(), name
    assert ops.launch_counts() == _counts(
        depth_fill=1, fps=4, ball_query_group=4, fp_interpolate=4,
        fold_upsample=1, bn_eval=55)


def _full_width_config(name, **overrides):
    """``config/<name>`` with the epoch cut to ``overrides``."""
    from pathlib import Path

    from istnet_tpu_torch.utils import Config

    cfg = Config.fromfile(Path(__file__).resolve().parent.parent / "config" / name)
    for key, value in overrides.items():
        cfg[key] = value
    return cfg


_TRAIN_PER_STEP = dict(fps=8, ball_query_group=8, fp_interpolate=8,
                       ball_query=6, group_scatter=6, three_nn=8,
                       interp_scatter=8)


@pytest.mark.parametrize("name,per_step", [
    ("ist_net_default.yaml", _TRAIN_PER_STEP),
    ("posenet_gt_default.yaml", dict(fps=8, ball_query_group=8,
                                     fp_interpolate=8, ball_query=3,
                                     group_scatter=3, three_nn=4,
                                     interp_scatter=4)),
    ("ist_net_device_pipeline.yaml", dict(_TRAIN_PER_STEP, depth_fill=1)),
])
def test_solver_steps_at_full_width_from_a_synthetic_tree(cuda, tmp_path, name,
                                                          per_step):
    """The shipped config's model, loaders and Solver (B = 18 + 6, N = 1024,
    192 x 192, SA npoints 512/256/128/64), cut to one epoch of 2 steps:
    finite losses, the step count, and every kernel launched as often as
    the step's path asks (PoseNetGT: the world extractor's backward only;
    the device input pipeline: kernel 11 once a step)."""
    from istnet_tpu_torch.cli.train import build_model
    from istnet_tpu_torch.data import synthetic
    from istnet_tpu_torch.data.dataset import TrainingDataset
    from istnet_tpu_torch.data.loader import DataLoader
    from istnet_tpu_torch.train.solver import Solver

    data_dir = str(tmp_path / "data")
    synthetic.build_train_trees(data_dir, n_scenes=4)
    cfg = _full_width_config(name, max_epoch=1,
                             num_mini_batch_per_epoch=2)
    train_cfg = TrainConfig.from_config(cfg)
    model = build_model(cfg, train_cfg).to(cuda).train()
    dl = cfg.train_dataloader
    raw = bool(cfg.train_dataset.get("use_device_preprocess", False))
    loaders = [DataLoader(TrainingDataset(cfg.train_dataset, data_dir,
                                          data_type=t, num_img_per_epoch=2 * bs,
                                          seed=s, device_preprocess=raw), bs)
               for t, bs, s in (("syn", int(dl.syn_bs), 1),
                                ("real_withLabel", int(dl.real_bs), 2))]
    solver = Solver(model, make_optimizer(model, train_cfg), train_cfg, cfg,
                    syn_loader=loaders[0], real_loader=loaders[1])
    ops.reset_launch_counts()
    records = solver.solve()
    assert [r["step"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for k, v in r.items()
               if k not in ("epoch", "step"))
    assert ops.launch_counts() == _counts(**{k: 2 * v
                                             for k, v in per_step.items()})


def test_checkpoint_written_on_the_card_restores_on_the_cpu(cuda, tmp_path):
    from istnet_tpu_torch.train import checkpoints

    cfg = TrainConfig()
    model = build_train_model(cuda, seed=2, sa_npoints=(32, 16, 8, 8))
    opt = make_optimizer(model, cfg)
    train_step(model, opt, make_train_batch(2, 128, 48, seed=6, device=cuda),
               0, torch.Generator(device=cuda).manual_seed(0), cfg)
    checkpoints.save_checkpoint(str(tmp_path), 5, model, opt, 1)
    on_cpu = checkpoints.restore_for_eval(str(tmp_path), 5, map_location="cpu")
    for k, v in model.state_dict().items():
        assert on_cpu["model"][k].device.type == "cpu"
        assert torch.equal(on_cpu["model"][k], v.cpu()), k
    cpu_model = build_train_model("cpu", seed=9, sa_npoints=(32, 16, 8, 8))
    cpu_opt = make_optimizer(cpu_model, cfg)
    checkpoints.restore_checkpoint(str(tmp_path), 5, cpu_model, cpu_opt)
    for k, v in model.state_dict().items():
        assert torch.equal(cpu_model.state_dict()[k], v.cpu()), k
    card_model = build_train_model(cuda, seed=9, sa_npoints=(32, 16, 8, 8))
    card_opt = make_optimizer(card_model, cfg)
    payload = checkpoints.restore_checkpoint(str(tmp_path), 5, card_model,
                                             card_opt)
    assert payload["step"] == 1
    state = card_opt.state_dict()["state"]
    assert state and all(s["exp_avg"].is_cuda for s in state.values())
    # Adam's step counts stay on the CPU, as a fresh run keeps them
    assert all(not s["step"].is_cuda for s in state.values())
    assert all(not s["step"].is_cuda for s in opt.state_dict()["state"].values())
    for k, v in model.state_dict().items():
        assert torch.equal(card_model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# The train step's device input pipeline
# ---------------------------------------------------------------------------

def _train_draws(b, sample_num, seed):
    """The device pipeline's draws, made on the CPU from ``seed``."""
    from istnet_tpu_torch.data import device_augment, device_preprocess
    from istnet_tpu_torch.data import device_transforms

    g = torch.Generator().manual_seed(seed)
    pre = device_preprocess.draw_preprocess(b, g, sample_num)
    pre["color"] = device_transforms.draw_color_jitter(b, g)
    return pre, device_augment.draw_augment(b, g)


def _on(tree, device):
    return {k: _on(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def test_device_train_preprocess_matches_the_cpu(cuda):
    """At the training batch (24 raw 480 x 640 frames, N = 1024, 192 x
    192), the card's preprocessing (kernel 11 and the torch ops) against
    the CPU's plain one with the same draws: ``choose`` and ``n_valid``
    equal, points within 1e-5 m (the fills differ by their bilateral's
    rounding, 1e-5 m allowed), ColorJitter's rgb within 2e-3 of a level,
    ``qo`` within 1e-5, each step of the pipeline once."""
    from istnet_tpu_torch.data import device_preprocess as dp
    from istnet_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
    from istnet_tpu_torch.entry import make_train_raw_batch

    raw = make_train_raw_batch(24, seed=3, device="cpu")
    pre, _ = _train_draws(24, 1024, 4)
    outs = []
    for device in ("cpu", cuda):
        r = _on(raw, device)
        depth = dp.fill_missing(r["depth_raw"])
        inst = dp.preprocess_train_instances(
            r["rgb_raw"], depth, r["mask_raw"], r["bbox"], r["intrinsics"],
            r["rotation_label"], r["translation_label"], r["size_label"],
            v=pre["v"].to(device), noise=pre["noise"].to(device))
        whole = dp.make_train_preprocess()(r, _on(pre, device))
        outs.append(({k: v.cpu() for k, v in inst.items()},
                     _on(whole, "cpu")))
    (inst_cpu, whole_cpu), (inst_gpu, whole_gpu) = outs
    assert torch.equal(inst_gpu["n_valid"], inst_cpu["n_valid"])
    assert torch.equal(inst_gpu["choose"], inst_cpu["choose"])
    assert (inst_gpu["pts"] - inst_cpu["pts"]).abs().max() <= 1e-5
    g, c = whole_gpu["inputs"], whole_cpu["inputs"]
    assert torch.equal(g["choose"], c["choose"])
    assert (g["pts"] - c["pts"]).abs().max() <= 1e-5
    assert (g["qo"] - c["qo"]).abs().max() <= 1e-5
    scale = torch.from_numpy(IMAGENET_STD * 255)
    assert ((g["rgb"] - c["rgb"]) * scale).abs().max() <= 2e-3
    assert torch.equal(whole_gpu["labels"]["qo"], g["qo"])


def test_device_train_pipeline_waits_for_nothing(cuda):
    """One preprocessing and augmentation call of the step on the card
    under ``torch.cuda.set_sync_debug_mode("error")``, its draws from a
    card generator: no host sync inside; kernel 11 launches once."""
    from istnet_tpu_torch.data.device_augment import make_device_augment
    from istnet_tpu_torch.data.device_preprocess import make_train_preprocess
    from istnet_tpu_torch.entry import make_train_raw_batch
    from istnet_tpu_torch.train.train_state import prepare_batch

    raw = make_train_raw_batch(24, seed=5, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    fns = (make_train_preprocess(), make_device_augment())
    prepare_batch(raw, gen, *fns)          # builds its constant tables
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        batch = prepare_batch(raw, gen, *fns)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts() == _counts(depth_fill=1)
    assert batch["inputs"]["pts"].shape == (24, 1024, 3)
    assert all(torch.isfinite(v).all() for part in batch.values()
               for v in part.values() if v.is_floating_point())


def test_card_train_step_repeats_bit_for_bit(cuda):
    """Two default-recipe steps on the card from one state, batch and
    generator seed: the loss parts and every gradient equal in their bits
    (the RGB branch's backward sums in a fixed order: the PSP resize, the
    per-point gather and, cuDNN deterministic inside the step, the trunk's
    convolutions)."""
    batch = make_train_batch(2, 128, 48, seed=5, device=cuda)
    runs, init = [], None
    for _ in range(2):
        model = build_train_model(cuda, seed=3, sa_npoints=(32, 16, 8, 8))
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        cfg = TrainConfig()
        ops.reset_launch_counts()
        parts = train_step(model, make_optimizer(model, cfg), batch, 0,
                           torch.Generator(device=cuda).manual_seed(1), cfg)
        # train mode keeps every BN's own chain: no eval BN pass
        assert ops.launch_counts()["bn_eval"] == 0
        runs.append(({k: v.cpu() for k, v in parts.items()},
                     {k: p.grad.cpu() for k, p in model.named_parameters()
                      if p.grad is not None}))
    (l1, g1), (l2, g2) = runs
    assert all(torch.equal(l1[k], l2[k]) for k in l1)
    differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    assert not differ, differ[:5]


@pytest.mark.parametrize("freeze", [False, True], ids=["default", "frozen"])
def test_ddp_world_one_over_nccl_is_bit_equal_to_the_plain_step(cuda, tmp_path,
                                                                freeze):
    """A process group of one rank over NCCL: 2 steps of the DDP-wrapped
    model (``parallel.mesh.wrap_dp``) give the plain card step's loss parts
    and state, every bit, and its launches."""
    from istnet_tpu_torch.parallel import multihost, wrap_dp

    cfg = TrainConfig.frozen() if freeze else TrainConfig()
    multihost.initialize("cuda", init_method=f"file://{tmp_path}/rdv",
                         rank=0, world_size=1)
    runs = []
    try:
        assert torch.distributed.get_backend() == "nccl"
        for wrap in (False, True):
            model = build_train_model(cuda, seed=3, sa_npoints=(32, 16, 8, 8),
                                      freeze_world_enhancer=freeze)
            opt = make_optimizer(model, cfg)
            step_model = wrap_dp(model) if wrap else model
            gen = torch.Generator(device=cuda).manual_seed(1)
            ops.reset_launch_counts()
            parts = [train_step(step_model, opt,
                                make_train_batch(4, 128, 48, seed=5 + k,
                                                 device=cuda), k, gen, cfg)
                     for k in range(2)]
            runs.append((parts, model.state_dict(), ops.launch_counts()))
    finally:
        multihost.shutdown()
    (p0, s0, c0), (p1, s1, c1) = runs
    assert c0 == c1 and c0["fps"] == 16
    assert all(torch.equal(a[k], b[k]) for a, b in zip(p0, p1) for k in a)
    differ = [k for k in s0 if not torch.equal(s0[k], s1[k])]
    assert not differ, differ[:5]


def test_umeyama_and_ransac_on_the_card_match_the_cpu(cuda):
    """The batched fit and the RANSAC's scoring on the card against the
    CPU on the same hypotheses (every hypothesis of at least 3 distinct
    points: fewer fix no rotation), and the RANSAC's own card draws
    against the truth."""
    from istnet_tpu_torch.ops import umeyama

    rng = np.random.RandomState(14)
    src = rng.randn(4, 300, 3) * 0.3
    tgt = np.empty_like(src)
    truth = []
    for i in range(4):
        r, _ = cv2.Rodrigues(rng.randn(3, 1))
        s, t = rng.uniform(0.5, 2.0), rng.randn(3)
        tgt[i] = src[i] @ (s * r).T + t
        out = rng.choice(300, 60, replace=False)
        tgt[i, out] += rng.randn(60, 3) * 3.0
        truth.append((s, r, t))
    s_cpu, t_cpu = torch.from_numpy(src), torch.from_numpy(tgt)
    idx = torch.randint(0, 300, (4, 128, 5),
                        generator=torch.Generator().manual_seed(0))
    cpu = umeyama.score_hypotheses(s_cpu, t_cpu, idx)
    card = umeyama.score_hypotheses(s_cpu.to(cuda), t_cpu.to(cuda),
                                    idx.to(cuda))
    fixed = torch.tensor([[len(set(h.tolist())) >= 3 for h in b]
                          for b in idx])
    assert torch.equal(card["ratios"].cpu()[fixed], cpu["ratios"][fixed])
    assert torch.equal(card["inlier_mask"].cpu(), cpu["inlier_mask"])
    for k in ("scale", "rotation", "translation", "transform"):
        err = (card[k].cpu() - cpu[k]).abs().max().item()
        assert err <= 1e-5 * max(1.0, cpu[k].abs().max().item()), (k, err)
    fit = umeyama.umeyama(s_cpu.to(cuda), t_cpu.to(cuda))
    want = umeyama.umeyama(s_cpu, t_cpu)
    for g, w in zip(fit, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-5 * max(
            1.0, w.abs().max().item())
    drawn = umeyama.ransac_similarity(
        s_cpu.to(cuda), t_cpu.to(cuda),
        torch.Generator(device=cuda).manual_seed(1))
    assert drawn["valid"].all()
    for i, (s, r, t) in enumerate(truth):
        assert abs(drawn["scale"][i].item() - s) <= 1e-2 * s
        assert np.abs(drawn["rotation"][i].cpu().numpy() - r).max() <= 1e-2
    es, er, et, _ = umeyama.estimate_similarity_transform(
        src[0], tgt[0], device="cuda")
    assert abs(es - truth[0][0]) <= 1e-2 * truth[0][0]


def test_resnet50_encoder_on_the_card_matches_the_cpu(cuda):
    """The Bottleneck trunk's eval forward, dense and sparse, on the card
    and on the CPU against the CPU's float64 forward: the card's error at
    most twice the CPU's float32 error (50 blocks of BN-normalised random
    layers amplify rounding: the CPU's own float32 forward is ~1e-3 off);
    the fold kernel launched once a forward, the eval BN pass once for
    every BN but up_2's."""
    import copy

    from istnet_tpu_torch.entry import build_encoder
    from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet

    enc = build_encoder("resnet50", cuda, seed=5, img=48)
    cpu = ModifiedResnet("resnet50")
    cpu.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()})
    cpu.eval()
    cpu64 = copy.deepcopy(cpu).double()
    rng = np.random.RandomState(6)
    rgb = torch.from_numpy(rng.rand(2, 48, 48, 3).astype(np.float32))
    choose = torch.from_numpy(rng.randint(0, 48 * 48, (2, 64)))
    with torch.inference_mode():
        ops.reset_launch_counts()
        dense = enc(rgb.to(cuda))
        sparse = enc.sparse_points(rgb.to(cuda), choose.to(cuda))
        torch.cuda.synchronize()
        bns = sum(isinstance(m, layers.BatchNorm) for m in enc.modules())
        assert ops.launch_counts() == _counts(fold_upsample=2,
                                              bn_eval=2 * (bns - 1))
        precision.set_compute_dtype(torch.float64)
        try:
            want = (cpu64(rgb.double()),
                    cpu64.sparse_points(rgb.double(), choose))
        finally:
            precision.set_compute_dtype(torch.float32)
        host = (cpu(rgb), cpu.sparse_points(rgb, choose))
        for got, h, w in zip((dense, sparse), host, want):
            card_err = (got.cpu().double() - w).abs().max().item()
            cpu_err = (h.double() - w).abs().max().item()
            assert card_err <= 2 * cpu_err, (card_err, cpu_err)


def test_float64_eval_forward_on_the_card_raises(cuda):
    """No kernel takes float64: under the float64 policy the encoder's
    eval forward on the card raises at the fold kernel's wrapper, and the
    plain fold never runs in the kernel's place."""
    from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet

    enc = ModifiedResnet().double().to(cuda).eval()
    rgb = torch.rand(1, 48, 48, 3, dtype=torch.float64, device=cuda)
    ops.reset_launch_counts()
    precision.set_compute_dtype(torch.float64)
    try:
        with torch.inference_mode(), pytest.raises(
                TypeError, match="fold_upsample_conv: float32 or bfloat16"):
            enc(rgb)
    finally:
        precision.set_compute_dtype(torch.float32)
    assert ops.launch_counts() == _counts()
