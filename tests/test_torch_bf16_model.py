"""The port's bf16 policy against the JAX package's: the SA module, the
whole ``ISTNet`` eval forward, and the policy's switches.

The JAX side runs its bf16 policy on the CPU with its fused SA path routed
through the TPU kernel in interpret mode (``monkeypatch.setattr(istnet_tpu.
ops, "sa_msg_fused", ...)``, the pattern of ``tests/test_sa_fused.py:
161-168``; stage 1 stays unfused, as the JAX default keeps it). The port
runs its plain versions. Weights are the port's random init with perturbed
BN statistics, carried to flax trees, given nonzero SharedMLP dense biases
there, and brought back by ``state_dict_from_jax`` with ``strict=True``.

Tolerances: the SA module within 2e-2 * max(1, max |JAX|) (the fused
kernel's contract). The whole forward at B=2, N=256, 48x48 crops,
``sa_npoints=(128, 128, 128, 64)`` (the smallest at which the JAX fused
kernel takes every SA stage: N % 128 == 0) within ``MODEL_TOL`` * max |JAX|
per output: measured 1.5e-3 (rotation), 4.2e-3 (NOCS), 2.7e-3
(translation) and 1.6e-3 (size) of the largest value, the same order as
the bf16-vs-f32 drift of either framework, because the two round at
different places (JAX's CPU graph rounds the FP interpolation weights to
bf16 and may keep excess precision in fused elementwise chains; the port
follows the TPU kernels and rounds every op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import istnet_tpu.ops as jax_ops
from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu.nn import precision as jax_precision
from istnet_tpu.ops.sa_fused_pallas import sa_msg_fused_pallas
from istnet_tpu_torch import ops
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.entry import build_model, build_serving_model, make_inputs
from istnet_tpu_torch.models.ist_net import CAM_RADII, ISTNet
from istnet_tpu_torch.nn import precision

torch.set_num_threads(1)

NPOINTS = (128, 128, 128, 64)
SA_TOL = 2e-2
MODEL_TOL = 1e-2


def _set_dense_biases(tree, rng, inside=False):
    """Nonzero SharedMLP dense biases (the port's convs have none)."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if inside and k == "Dense_0":
            v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
        else:
            _set_dense_biases(v, rng, inside or k.startswith("SharedMLP"))


@pytest.fixture(scope="module")
def models():
    src = build_model(sa_npoints=NPOINTS, seed=5, device="cpu")
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(5))
    port = ISTNet(sa_npoints=NPOINTS)
    port.load_state_dict(state_dict_from_jax(trees), strict=True)
    return port.eval(), trees


def _interpret_fused(calls: list):
    """A stand-in for ``istnet_tpu.ops.sa_msg_fused`` that runs the TPU
    kernel in interpret mode and records each call."""
    def fused(radii, nsamples, xyz, new_xyz, features, folded):
        if features is None:
            return None                     # stage 1 stays unfused
        calls.append(xyz.shape)
        return sa_msg_fused_pallas(tuple(radii), tuple(nsamples), xyz,
                                   new_xyz, features, tuple(folded),
                                   interpret=True)
    return fused


@pytest.fixture
def bf16(monkeypatch):
    """Both frameworks under bf16; the JAX fused SA path in interpret mode
    and counted; both policies restored afterwards."""
    calls = []
    monkeypatch.setattr(jax_ops, "sa_msg_fused", _interpret_fused(calls))
    old_j, old_t = jax_precision.compute_dtype(), precision.compute_dtype()
    jax_precision.set_compute_dtype(jnp.bfloat16)
    precision.set_compute_dtype(torch.bfloat16)
    yield calls
    jax_precision.set_compute_dtype(old_j)
    precision.set_compute_dtype(old_t)


def _spy_port_fused(monkeypatch):
    calls = []
    real = ops.sa_msg_fused

    def spy(*args):
        calls.append(args[2].shape)
        return real(*args)

    monkeypatch.setattr(ops, "sa_msg_fused", spy)
    return calls


def test_sa_module_matches_jax_under_bf16(models, bf16, monkeypatch):
    """SA stage 2 alone (features present): both take the fused path."""
    from istnet_tpu.nn.pointnet2_msg import PointnetSAModuleMSG

    port, trees = models
    port_calls = _spy_port_fused(monkeypatch)
    rng = np.random.RandomState(8)
    xyz = (rng.randn(2, 128, 3) * 0.05).astype(np.float32)
    feats = np.maximum(rng.randn(2, 128, 64), 0).astype(np.float32)
    jsa = PointnetSAModuleMSG(npoint=128, radii=CAM_RADII[1],
                              nsamples=(16, 32), mlps=((32, 32, 64),) * 2)
    name = "PointnetSAModuleMSG_1"
    variables = {"params": trees["params"]["pts_cam_extractor"][name],
                 "batch_stats": trees["batch_stats"]["pts_cam_extractor"][name]}
    jxyz, jfeats = jax.jit(lambda v, x, f: jsa.apply(v, x, f, train=False))(
        variables, jnp.asarray(xyz),
        jnp.asarray(feats).astype(jnp.bfloat16))
    with torch.no_grad():
        txyz, tfeats = port.pts_cam_extractor.SA_modules[1](
            torch.from_numpy(xyz), torch.from_numpy(feats).bfloat16())
    assert bf16 and port_calls
    np.testing.assert_array_equal(txyz.numpy(), np.asarray(jxyz))
    assert tfeats.dtype == torch.bfloat16 and jfeats.dtype == jnp.bfloat16
    want = np.asarray(jfeats, np.float32)
    np.testing.assert_allclose(tfeats.float().numpy(), want, rtol=0,
                               atol=SA_TOL * max(1.0, np.abs(want).max()))


@pytest.fixture(scope="module")
def forward_bf16(models):
    """Both whole forwards under bf16 (set and restored here: a module
    fixture cannot take the function-scoped monkeypatch)."""
    port, trees = models
    calls = []
    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet

    inputs = make_inputs(2, 256, 48, seed=11, device="cpu")
    real = jax_ops.sa_msg_fused
    old_j, old_t = jax_precision.compute_dtype(), precision.compute_dtype()
    jax_ops.sa_msg_fused = _interpret_fused(calls)
    jax_precision.set_compute_dtype(jnp.bfloat16)
    precision.set_compute_dtype(torch.bfloat16)
    try:
        jm = JaxISTNet(sa_npoints=NPOINTS)
        want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(
            trees, {k: jnp.asarray(v.numpy()) for k, v in inputs.items()})
        ops.reset_launch_counts()
        with torch.no_grad():
            got = port(inputs)
    finally:
        jax_ops.sa_msg_fused = real
        jax_precision.set_compute_dtype(old_j)
        precision.set_compute_dtype(old_t)
    return got, {k: np.asarray(v) for k, v in want.items()}, calls


@pytest.mark.parametrize("key", ["pred_rotation", "pred_translation",
                                 "pred_size", "pred_qo"])
def test_bf16_forward_matches_jax(forward_bf16, key):
    got, want, calls = forward_bf16
    assert len(calls) == 3                     # JAX fused SA stages 2-4
    assert got[key].dtype == torch.float32 and want[key].dtype == np.float32
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                               atol=MODEL_TOL * np.abs(want[key]).max())


def test_bf16_cpu_forward_launches_nothing_and_is_orthonormal(forward_bf16):
    got, _, _ = forward_bf16
    assert all(v == 0 for v in ops.launch_counts().values())
    r = got["pred_rotation"]
    torch.testing.assert_close(r.transpose(1, 2) @ r,
                               torch.eye(3).expand(2, 3, 3), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# The policy
# ---------------------------------------------------------------------------

def test_fused_sa_runs_only_under_bf16_at_eval(models, monkeypatch):
    """The gate of ``pointnet2_msg.py:98-107``: an f32 policy never reaches
    the fused kernel; bf16 takes it at SA stages 2-4 and not at stage 1."""
    port, _ = models
    calls = _spy_port_fused(monkeypatch)
    inputs = make_inputs(1, 256, 48, seed=2, device="cpu")
    old = precision.compute_dtype()
    try:
        precision.set_compute_dtype(torch.float32)
        with torch.no_grad():
            port(inputs)
        assert calls == []
        precision.set_compute_dtype(torch.bfloat16)
        with torch.no_grad():
            port(inputs)
    finally:
        precision.set_compute_dtype(old)
    assert [s[1] for s in calls] == [128, 128, 128]


def test_bf16_policy_sets_f32_accumulation_and_refuses_other_dtypes():
    flag = torch.backends.cuda.matmul
    old_flag, old = flag.allow_bf16_reduced_precision_reduction, \
        precision.compute_dtype()
    try:
        flag.allow_bf16_reduced_precision_reduction = True
        precision.set_compute_dtype(torch.bfloat16)
        precision.apply_policy()
        assert flag.allow_bf16_reduced_precision_reduction is False
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            precision.set_compute_dtype(torch.float16)
    finally:
        flag.allow_bf16_reduced_precision_reduction = old_flag
        precision.set_compute_dtype(old)


def test_build_serving_model_sets_the_policy():
    old = precision.compute_dtype()
    try:
        model = build_serving_model(torch.bfloat16, "cpu",
                                    sa_npoints=(16, 8, 8, 8))
        assert precision.compute_dtype() == torch.bfloat16
        with torch.no_grad():
            out = model(make_inputs(1, 64, 48, seed=1, device="cpu"))
        assert all(v.dtype == torch.float32 for v in out.values())
    finally:
        precision.set_compute_dtype(old)
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_chip_smoke_checks_the_bf16_kernels_at_the_path_shapes(monkeypatch):
    """The shapes chip_smoke.py holds each bf16 kernel to are the ones the
    full-width bf16 forward gives it (recorded here on the CPU at B=1)."""
    import chip_smoke
    from istnet_tpu_torch.nn import pointnet2_msg, resnet_psp

    seen = {"ball_query_group": [], "fp_interpolate": [], "fold_upsample": [],
            "sa_fused": []}

    def spy(name, fn, shape):
        def wrapped(*args, **kwargs):
            seen[name].append(shape(*args, **kwargs))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(pointnet2_msg.ops, "ball_query_group", spy(
        "ball_query_group", ops.ball_query_group,
        lambda r, ns, x, c, f, out_dtype: (x.shape[1], c.shape[1], out_dtype)))
    monkeypatch.setattr(pointnet2_msg.ops, "fp_interpolate", spy(
        "fp_interpolate", ops.fp_interpolate,
        lambda u, k, f: (u.shape[1], k.shape[1], f.shape[-1], f.dtype)))
    monkeypatch.setattr(resnet_psp.ops, "fold_upsample_conv", spy(
        "fold_upsample", ops.fold_upsample_conv,
        lambda x, packed: (*x.shape[1:], packed.k.shape[-1], x.dtype)))
    monkeypatch.setattr(pointnet2_msg.ops, "sa_msg_fused", spy(
        "sa_fused", ops.sa_msg_fused,
        lambda r, ns, x, c, f, folded: (
            x.shape[1], c.shape[1], f.shape[-1],
            folded.chans[0][1:])))
    old = precision.compute_dtype()
    try:
        precision.set_compute_dtype(torch.bfloat16)
        with torch.no_grad():
            build_model(device="cpu")(make_inputs(1, device="cpu"))
    finally:
        precision.set_compute_dtype(old)
    bf = torch.bfloat16
    n, m, _ = chip_smoke.BQG_SHAPES[0]
    assert seen == {
        "ball_query_group": [(n, m, bf)],
        "fp_interpolate": [(*s, bf) for s in chip_smoke.FP_SHAPES],
        "fold_upsample": [(*chip_smoke.FOLD_SHAPE, bf)],
        "sa_fused": list(chip_smoke.SA_FUSED_SHAPES)}


# ---------------------------------------------------------------------------
# Folded and packed weights: built once per module, never stale
# ---------------------------------------------------------------------------

SMALL = (32, 16, 8, 8)


def _fresh_pack(sa):
    from istnet_tpu_torch.nn.pointnet2_msg import _fold_shared_mlp
    from istnet_tpu_torch.ops.sa_fused import pack_folded
    return pack_folded([_fold_shared_mlp(mlp) for mlp in sa.mlps])


def _same_pack(a, b):
    return (a.chans == b.chans
            and all(torch.equal(x, y) for ws, vs in zip(a.ws, b.ws)
                    for x, y in zip(ws, vs))
            and all(torch.equal(x, y) for bs, cs in zip(a.bs, b.bs)
                    for x, y in zip(bs, cs)))


def _load_scaled(sa):
    sa.load_state_dict({k: v * 1.5 if v.is_floating_point() else v
                        for k, v in sa.state_dict().items()})


def _edit_weight(sa):
    sa.mlps[0].layer0.conv.weight.mul_(2.0)


def _edit_bias(sa):
    sa.mlps[1].layer2.normlayer.bn.bias.add_(0.25)


def _edit_running_var(sa):
    sa.mlps[1].layer1.normlayer.bn.running_var.add_(1.0)


def _train_eval_round_trip(sa):
    # a write through .data moves no version counter; train() drops the
    # cache whatever happened in between
    sa.train()
    sa.mlps[0].layer1.conv.weight.data.mul_(3.0)
    sa.eval()


def _to_float64(sa):
    sa.double()


def _replace_parameter(sa):
    # a new Parameter object in the old one's place, nothing edited in place
    conv = sa.mlps[0].layer1.conv
    conv.weight = torch.nn.Parameter(conv.weight.detach() * 0.5)


@pytest.mark.parametrize("change", [_load_scaled, _edit_weight, _edit_bias,
                                    _edit_running_var, _train_eval_round_trip,
                                    _to_float64, _replace_parameter])
def test_sa_module_refolds_when_its_weights_change(change):
    """``PointnetSAModuleMSG.folded`` packs once and hands the same object
    back until a parameter or buffer it was made from changes."""
    from istnet_tpu_torch.ops.sa_fused import PackedFolded
    sa = build_model(sa_npoints=SMALL, seed=3, device="cpu").eval() \
        .pts_cam_extractor.SA_modules[2]
    with torch.no_grad():
        first = sa.folded()
        assert isinstance(first, PackedFolded)
        assert sa.folded() is first                   # built once
        assert _same_pack(first, _fresh_pack(sa))
        change(sa)
        second = sa.folded()
        assert second is not first and sa.folded() is second
        assert not _same_pack(second, first) or change is _to_float64
        assert _same_pack(second, _fresh_pack(sa))    # never stale


def test_derived_cache_keeps_its_sources_alive():
    """An entry holds the tensors it was made from, so a tensor allocated
    later can never pass for one of them by identity, address and version;
    ``clear`` lets them go."""
    import weakref

    from istnet_tpu_torch.nn.layers import DerivedCache
    cache = DerivedCache()
    t = torch.zeros(3)
    ref = weakref.ref(t)
    assert cache.get([t], None, lambda: "first") == "first"
    assert cache.get([t], None, lambda: "again") == "first"
    twin = t.detach()                  # same storage and version, another object
    assert cache.get([twin], None, lambda: "twin") == "twin"
    del t, twin
    cache.get([torch.zeros(3)], None, lambda: "next")
    assert ref() is None               # the old sources went with their entry
    t = torch.zeros(3)
    ref = weakref.ref(t)
    cache.get([t], None, lambda: "kept")
    del t
    assert ref() is not None
    cache.clear()
    assert ref() is None


def test_sa_module_folds_anew_while_a_graph_is_recorded():
    sa = build_model(sa_npoints=SMALL, seed=3, device="cpu").eval() \
        .pts_cam_extractor.SA_modules[1]
    with torch.enable_grad():
        folded = sa.folded()
    assert isinstance(folded, list) and folded[0][0][0].requires_grad
    with torch.no_grad():
        assert sa.folded() is sa.folded()


def test_up_2_repacks_when_its_weights_or_the_policy_change():
    from istnet_tpu_torch.ops.fold_upsample import PackedFold, pack_kernel
    up = build_model("cpu", sa_npoints=SMALL, seed=3).eval() \
        .rgb_cam_extractor.model.up_2
    old = precision.compute_dtype()
    try:
        with torch.no_grad():
            first = up.packed()
            assert isinstance(first, PackedFold) and up.packed() is first
            assert first.km.dtype == torch.float32
            precision.set_compute_dtype(torch.bfloat16)
            half = up.packed()
            assert half is not first and half.km.dtype == torch.bfloat16
            assert half.epilogue.dtype == torch.float32
            up.conv[1].weight.mul_(2.0)
            third = up.packed()
            assert third is not half and up.packed() is third
            k = up.conv[1].weight.permute(2, 3, 1, 0).bfloat16()
            assert torch.equal(third.km, pack_kernel(k))
            up.conv[2].running_mean.add_(0.5)
            assert torch.equal(up.packed().epilogue, up.epilogue())
            up.train()
            up.conv[3].weight.data.fill_(0.125)
            up.eval()
            assert up.packed().epilogue[4].eq(0.125).all()
    finally:
        precision.set_compute_dtype(old)


def test_bf16_forward_with_the_caches_equals_the_forward_without(monkeypatch):
    """The bf16 eval forward at B=2, N=128, 48 x 48 with the folded and
    packed weights cached equals, bit for bit, the forward that folds and
    packs on every call; and after new weights are loaded it equals a fresh
    model's."""
    from istnet_tpu_torch.nn.layers import DerivedCache
    rng = np.random.RandomState(11)
    inputs = make_inputs(2, 128, 48, seed=4, device="cpu")
    inputs["pts"] = torch.from_numpy(
        (rng.randn(2, 128, 3) * 0.03).astype(np.float32))

    def run(model):
        with torch.no_grad():
            return model(inputs)

    old = precision.compute_dtype()
    precision.set_compute_dtype(torch.bfloat16)
    try:
        model = build_model(sa_npoints=SMALL, seed=2, device="cpu")
        cached = [run(model), run(model)]             # build, then reuse
        packs = [sa._folded._value for sa in model.pts_cam_extractor.SA_modules]
        assert packs[0] is None and all(p is not None for p in packs[1:])
        other = build_model(sa_npoints=SMALL, seed=6, device="cpu")
        model.load_state_dict(other.state_dict())
        reloaded = run(model)
        monkeypatch.setattr(DerivedCache, "get",
                            lambda self, tensors, extra, build: build())
        model2 = build_model(sa_npoints=SMALL, seed=2, device="cpu")
        plain_run, other_run = run(model2), run(other)
        assert all(sa._folded._value is None
                   for sa in model2.pts_cam_extractor.SA_modules)
    finally:
        precision.set_compute_dtype(old)
    for k, want in plain_run.items():
        assert torch.isfinite(want).all()
        assert torch.equal(cached[0][k], want), k
        assert torch.equal(cached[1][k], want), k
        assert torch.equal(reloaded[k], other_run[k]), k
        assert not torch.equal(reloaded[k], want), k
