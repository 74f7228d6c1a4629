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

Training (float32): the backward kernels (8: multi-radius ball query, the
grouping scatter, 10: 3-NN, the interpolation scatter) against their plain
versions, indices and distances equal, scatters to 1e-5 of the largest
value (f32 atomics add in another order); the dispatch ops' gradients on
the card against autograd through the plain ops on the CPU; one tiny train
step on the card against the same step on the CPU.
"""

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
from istnet_tpu_torch.ops import dispatch, fold_upsample, sa_fused
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
    model = build_model(sa_npoints=(32, 16, 8, 8), seed=2)
    inputs = make_inputs(2, 128, 48, seed=4)
    with torch.no_grad():
        want = model(inputs)
        model.to(cuda)
        ops.reset_launch_counts()
        got = model({k: v.to(cuda) for k, v in inputs.items()})
    assert ops.launch_counts() == _counts(fps=4, ball_query_group=4,
                                          fp_interpolate=4, fold_upsample=1)
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
    assert ops.launch_counts() == _counts(fps=4, ball_query_group=1,
                                          fp_interpolate=4, fold_upsample=1,
                                          sa_fused=3)
    # measured <= 8.7e-4 (cuDNN and cuBLAS round bf16 after other sums)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=5e-3)


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
    batch = make_train_batch(2, 128, 48, seed=5)
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
