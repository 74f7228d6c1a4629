"""The port's train branch and train step against the JAX package.

The slice: ``ISTNet(sa_npoints=(32, 16, 8, 8))`` at B=2, N=128, 48x48
crops on the CPU (the port's plain ops; JAX's XLA ops). Weights: the port's
random init with perturbed BN statistics, converted to flax trees, given
nonzero SharedMLP dense biases there, and carried back by
``state_dict_from_jax`` into a port model loaded strictly. Dropout is off
on both sides (it has no golden-value contract).

- The train branch's outputs, float32, both recipes.
- The trajectory: 3 steps of the port's ``train_step`` against JAX's
  ``make_train_step`` + ``make_optimizer``, both recipes, with a small
  ``step_size_up`` and ``decay_step`` so that the LR and the BN momentum
  move. Compared: the per-step losses and the final states key by key
  (through ``state_dict_from_jax``). In float64 on both sides, as the JAX
  package's own torch-parity trajectory test runs
  (``tests/test_convert_istnet.py:585-595``): in float32 the two frameworks'
  reduction orders flip near-ties of the slot max and of ReLU, and Adam
  turns any gradient whose true value is ~0 (the dense biases before a
  train-mode BN) into a +-lr step of noise. In float64 the decisions stay
  float32 on both sides, as do the head outputs and the losses.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu_torch import ops
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.entry import build_model, make_train_batch
from istnet_tpu_torch.models.ist_net import ISTNet, supervised_loss
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.nn.resnet_psp import PSPUpsample
from istnet_tpu_torch.train.train_state import (
    TrainConfig,
    batch_norms,
    make_optimizer,
    train_step,
)

torch.set_num_threads(1)

TINY = (32, 16, 8, 8)
B, N, IMG = 2, 128, 48


def _set_dense_biases(tree, rng, inside=False):
    """Nonzero SharedMLP dense biases (the port's convs have none)."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if inside and k == "Dense_0":
            v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
        else:
            _set_dense_biases(v, rng, inside or k.startswith("SharedMLP"))


def _dense_biases(tree, inside=False, path=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dense_biases(v, inside or k.startswith("SharedMLP"),
                                     f"{path}/{k}"))
        elif inside and k == "bias" and path.endswith("Dense_0"):
            out[path] = np.asarray(v)
    return out


def _trees(seed):
    src = build_model(sa_npoints=TINY, seed=seed)
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(seed))
    return trees


def _port(trees, freeze, dtype=torch.float32):
    model = ISTNet(sa_npoints=TINY, freeze_world_enhancer=freeze)
    model.load_state_dict(state_dict_from_jax(trees), strict=True)
    model.to(dtype).train()
    for m in model.modules():
        if isinstance(m, layers.Dropout2d):
            m.eval()
    return model


def _no_jax_dropout(monkeypatch):
    from istnet_tpu.nn import layers as jl
    monkeypatch.setattr(jl.Dropout2d, "__call__", lambda self, x, train: x)


def _batch(k, dtype=np.float32):
    """Step ``k``'s inputs and labels, numpy. The 128 points are spread
    (std 3 cm) so that the camera radii (1-16 cm) find neighbours, as 1024
    points of std 10 cm do at full width: spread at std 10 cm, 128 points
    leave most SA-stage BN channels with a variance far below eps, each BN
    then amplifies the gradient ~300x, and the camera extractor's
    gradients reach 1e21, where no comparison is meaningful."""
    rng = np.random.RandomState(100 + k)
    inputs = {
        "rgb": rng.randn(B, IMG, IMG, 3).astype(dtype),
        "pts": (rng.randn(B, N, 3) * 0.03).astype(dtype),
        "choose": rng.randint(0, IMG * IMG, (B, N)).astype(np.int32),
        "category_label": np.array([k % 6, (k + 3) % 6], np.int32),
        "qo": ((rng.rand(B, N, 3) - 0.5) * 0.4).astype(dtype),
    }
    labels = {
        "rotation_label": rng.randn(B, 3, 3).astype(dtype),
        "translation_label": (rng.randn(B, 3) * 0.1).astype(dtype),
        "size_label": rng.rand(B, 3).astype(dtype),
        "qo": inputs["qo"],
    }
    return {"inputs": inputs, "labels": labels}


def _torch(batch):
    return {part: {k: torch.from_numpy(v) for k, v in d.items()}
            for part, d in batch.items()}


# ---------------------------------------------------------------------------
# The train branch
# ---------------------------------------------------------------------------

def _to64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a,
        tree)


@contextlib.contextmanager
def _jax_float64():
    """JAX under x64 with its float64 policy, as its own parity tests run."""
    from istnet_tpu.nn import precision as jprecision

    jax.config.update("jax_enable_x64", True)
    jprecision.set_compute_dtype(np.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        jprecision.set_compute_dtype(np.float32)


# per output, max|port - JAX float64| / max|JAX float64|
BRANCH_F32_TOL = 1e-4   # the port's float32 forward (measured <= 2.1e-5)
BRANCH_F64_TOL = 1e-6   # the port's float64 forward (measured <= 1.5e-7)


@pytest.mark.parametrize("freeze", [False, True], ids=["default", "frozen"])
def test_train_branch_matches_jax(monkeypatch, freeze):
    """The train-mode outputs (BN batch statistics, the dense encoder head,
    the auxiliary heads, the world enhancer) and the loss, of the port's
    float32 and float64 forwards, against ``ISTNet.apply(train=True)``
    and ``supervised_loss`` under JAX's float64 policy, on the same
    float32-valued weights and inputs.

    The reference is JAX's float64 result because JAX's own float32 train
    forward is ill-conditioned here: its one-pass float32 BN variance
    cancels on SA activations whose mean is far above their spread, and
    the error compounds through the stages. Measured at this slice: JAX
    float32 off JAX float64 by up to 11.5% of an output's largest value
    (``pts_w_local``; 1.3% in ``pred_qo``). The port's float32 forward,
    with its two-pass variance (``nn/layers.py::BatchNorm``), stays within
    2.1e-5 (``pts_w_local_gt``; <= 3.9e-6 elsewhere), its float64 forward
    within 1.5e-7 (the pose heads are float32 on both sides). The loss,
    float32 on both sides, within 1e-6 relative (measured <= 2e-7)."""
    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet
    from istnet_tpu.models.ist_net import supervised_loss as jax_loss

    _no_jax_dropout(monkeypatch)
    trees = _trees(seed=21)
    batch = _batch(0)
    gamma2 = 100.0 if freeze else 10.0
    jm = JaxISTNet(sa_npoints=TINY, freeze_world_enhancer=freeze)
    with _jax_float64():
        batch64 = _to64(batch)
        want = jax.jit(lambda v, i: jm.apply(v, i, train=True))(
            _to64(trees), batch64["inputs"])
        j_total, _ = jax_loss(want, batch64["labels"], 8.0, gamma2, freeze)
        want = {k: np.asarray(v, np.float64) for k, v in want.items()}
        j_total = float(j_total)

    for dtype, tol, b in ((torch.float32, BRANCH_F32_TOL, batch),
                          (torch.float64, BRANCH_F64_TOL, batch64)):
        precision.set_compute_dtype(dtype)
        try:
            port = _port(trees, freeze, dtype)
            t_batch = _torch(b)
            got = port(t_batch["inputs"])
            total, parts = supervised_loss(got, t_batch["labels"], 8.0,
                                           gamma2, freeze)
        finally:
            precision.set_compute_dtype(torch.float32)
        assert set(got) == set(want)
        for k, w in want.items():
            scale = np.abs(w).max()
            err = np.abs(got[k].detach().double().numpy() - w).max()
            assert err <= tol * scale, f"{dtype} {k}: {err} vs max {scale}"
        np.testing.assert_allclose(float(total), j_total, rtol=1e-6)
        assert got["pts_w_local_gt"].requires_grad != freeze
        assert all(v.requires_grad for k, v in parts.items())


def test_up_2_takes_the_plain_fold_and_batch_statistics_in_training(
        monkeypatch):
    """The fold kernel bakes the eval BN into its epilogue, so in training
    ``up_2`` must not call it: plain fold, then BN on batch statistics,
    then PReLU (``istnet_tpu/nn/resnet_psp.py:222-231``)."""
    from istnet_tpu_torch.nn import resnet_psp

    calls = []
    monkeypatch.setattr(resnet_psp.ops, "fold_upsample_conv",
                        lambda *a: calls.append(a))
    up = PSPUpsample(8, 4, fold_kernel=True).train()
    x = torch.randn(2, 5, 6, 8, generator=torch.Generator().manual_seed(0))
    got = up(x)
    conv, bn = up.conv[1], up.conv[2]
    y = layers.conv3x3_on_doubled(x, conv.weight.permute(2, 3, 1, 0),
                                  conv.bias)
    mean = y.mean(dim=(0, 1, 2))
    var = y.var(dim=(0, 1, 2), correction=0)
    want = up.conv[3]((y - mean) * torch.rsqrt(var + bn.eps) * bn.weight
                      + bn.bias)
    assert calls == []
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    up.eval()(x)
    assert len(calls) == 1                     # eval takes the kernel


def test_dropout_draws_from_the_step_generator():
    """In training the three Dropout2d applications change the outputs and
    draw their masks from the generator the step passes: the same seed
    gives the same outputs."""
    model = build_model(sa_npoints=TINY, seed=3).train()
    inputs = _torch(_batch(1))["inputs"]
    with torch.no_grad():
        a = model(inputs, torch.Generator().manual_seed(5))["pred_qo"]
        b = model(inputs, torch.Generator().manual_seed(5))["pred_qo"]
        c = model(inputs, torch.Generator().manual_seed(6))["pred_qo"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="Generator"):
        model(inputs)


def test_frozen_step_trains_everything_but_the_world_enhancer():
    cfg = TrainConfig.frozen()
    model = build_model(sa_npoints=TINY, seed=4,
                        freeze_world_enhancer=True).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, cfg)
    assert not any(p is q for g in opt.param_groups for p in g["params"]
                   for q in model.world_enhancer.parameters())
    ops.reset_launch_counts()
    parts = train_step(model, opt, make_train_batch(B, N, IMG, seed=2), 0,
                       torch.Generator().manual_seed(0), cfg)
    assert set(parts) == {"pose", "aux_cam", "qo", "feat", "total"}
    assert all(torch.isfinite(v) for v in parts.values())
    after = model.state_dict()
    moved = {k for k in after if not torch.equal(after[k], before[k])}
    world = {k for k in after if k.startswith("world_enhancer.")}
    # the world enhancer's parameters stay, its BN statistics move
    assert {k for k in moved & world if "running" not in k
            and "num_batches" not in k} == set()
    assert any(k.startswith("world_enhancer.extractor") and
               k.endswith("running_mean") for k in moved)
    assert "main_estimator.pose_mlp1.0.weight" in moved
    assert all(v == 0 for v in ops.launch_counts().values())   # CPU


def test_scheduled_ema_updates_every_batch_norm():
    cfg = TrainConfig(decay_step=1)
    model = build_model(sa_npoints=TINY, seed=6).train()
    bns = batch_norms(model)
    old = [(bn.running_mean.clone(), bn.running_var.clone()) for bn in bns]
    train_step(model, make_optimizer(model, cfg),
               make_train_batch(B, N, IMG, seed=3), 1,
               torch.Generator().manual_seed(1), cfg)
    m = cfg.momentum(1)
    assert m == np.float32(0.45)
    for bn, (mean, var) in zip(bns, old):
        assert bn.num_batches_tracked == 1
        torch.testing.assert_close(bn.running_mean,
                                   (1 - m) * mean + m * bn.batch_mean)
        torch.testing.assert_close(bn.running_var,
                                   (1 - m) * var + m * bn.batch_var)


# ---------------------------------------------------------------------------
# The trajectory
# ---------------------------------------------------------------------------

STEPS = 3
MAX_EPOCH, ITERS = 3, 12                      # step_size_up 6: the LR moves
BN_CFG = dict(bn_momentum=0.9, bn_decay=0.5, decay_step=2, bnm_clip=0.01)


def _jax_trajectory(trees, freeze, gamma2):
    """JAX's ``make_train_step`` + ``make_optimizer`` under x64 and its
    float64 policy: per-step losses, the exported final state, and the
    SharedMLP dense biases before and after."""
    import jax.numpy as jnp

    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet
    from istnet_tpu.models.ist_net import supervised_loss as jax_loss
    from istnet_tpu.train.train_state import (
        create_train_state,
        make_optimizer as jax_make_optimizer,
        make_train_step,
    )
    from istnet_tpu.utils.config import Config

    with _jax_float64():
        params, stats = _to64(trees["params"]), _to64(trees["batch_stats"])
        cfg = Config({"optimizer": {"name": "Adam", "lr": 1e-4,
                                    "weight_decay": 0.0},
                      "max_epoch": MAX_EPOCH, "bn": BN_CFG})
        tx, _ = jax_make_optimizer(
            cfg, ITERS, params,
            frozen_prefix="world_enhancer" if freeze else None)
        model = JaxISTNet(sa_npoints=TINY, freeze_world_enhancer=freeze)
        step = jax.jit(make_train_step(
            model, lambda e, l: jax_loss(e, l, 8.0, gamma2, freeze), tx,
            cfg.bn))
        state = create_train_state(params, stats, tx)
        losses, states = [], []
        for k in range(STEPS):
            b = _batch(k, np.float64)
            state, metrics = step(state, jax.tree_util.tree_map(jnp.asarray, b),
                                  jax.random.PRNGKey(k))
            losses.append(float(metrics["loss"]))
            states.append({"params": jax.device_get(state.params),
                           "batch_stats": jax.device_get(state.batch_stats)})
        return (losses, [state_dict_from_jax(t) for t in states],
                _dense_biases(params), _dense_biases(states[-1]["params"]))


def _check_state(got, want, init, lr_sum, bulk, freeze):
    """``got`` (the port's state) against ``want`` (JAX's, exported) key by
    key, parameters on the scale of ``lr_sum`` (Adam moves an element by at
    most ~lr a step), running statistics on the scale of their own move."""
    assert set(got) == set(want)
    for key, g in got.items():
        if key.endswith("num_batches_tracked") or ".feats.fc." in key:
            continue          # JAX keeps no count; the dead fc is zeroed
        d = (g - want[key].double()).abs().flatten().numpy()
        moved = (g - init[key]).abs().max().item()
        if "running" in key:
            assert d.max() <= 1e-12 + 1e-6 * moved, (key, d.max(), moved)
            continue
        assert d.max() <= 1e-12 + 0.05 * lr_sum, (key, d.max(), lr_sum)
        if d.size >= 10_000:
            assert np.quantile(d, 0.9) <= bulk * lr_sum, key
        if freeze and key.startswith("world_enhancer."):
            assert moved == 0.0, key


@pytest.mark.parametrize("freeze", [False, True], ids=["default", "frozen"])
def test_trajectory_matches_jax(monkeypatch, freeze):
    """3 updates of the composed recurrence (forward, loss, backward, Adam
    with the cyclic LR, the scheduled BN EMA) track JAX's, float64.

    Measured (both recipes): losses within 2.8e-7 relative; running
    statistics within 1.1e-7 of their own move. Parameters: after step 1
    within 1.1e-2 of the LR (the 90% bulk within 1.3e-4 of it); after step
    3 within 1.5e-2 of the summed LR (bulk 2.3e-5). The parameters' noise
    is Adam's: it divides each gradient by its own magnitude, so elements
    whose gradient is ~0 take the last bits of the two frameworks' sums
    (the heads, rotations and losses are float32 islands on both sides)
    to a step of up to ~lr. A schedule, beta or eps off by one would move
    the bulk by ~lr; the bounds below sit ~4x over the measured noise."""
    _no_jax_dropout(monkeypatch)
    gamma2 = 100.0 if freeze else 10.0
    trees = _trees(seed=31)
    j_losses, j_states, b0, b1 = _jax_trajectory(trees, freeze, gamma2)
    # the port's BN EMA tracks JAX's `running_mean - b` (the bridge's fold)
    # only while JAX's dense biases b stay: under train-mode BN their
    # gradient is 0 but for rounding, so Adam's step on them is ~lr *
    # |g| / eps, not ~lr (measured 9.4e-9 in all, against lr >= 1e-5)
    assert max(np.abs(b1[k] - b0[k]).max() for k in b0) <= 1e-7

    cfg = TrainConfig(gamma1=8.0, gamma2=gamma2, freeze_world_enhancer=freeze,
                      max_epoch=MAX_EPOCH, iters_per_epoch=ITERS,
                      bn_momentum=BN_CFG["bn_momentum"],
                      bn_decay=BN_CFG["bn_decay"],
                      decay_step=BN_CFG["decay_step"],
                      bnm_clip=BN_CFG["bnm_clip"])
    assert cfg.step_size_up == 6
    precision.set_compute_dtype(torch.float64)
    try:
        model = _port(trees, freeze, torch.float64)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model, cfg)
        t_losses, states = [], []
        for k in range(STEPS):
            parts = train_step(model, opt, _torch(_batch(k, np.float64)), k,
                               torch.Generator(), cfg)
            t_losses.append(float(parts["total"]))
            states.append({k: v.clone() for k, v in model.state_dict().items()})
    finally:
        precision.set_compute_dtype(torch.float32)

    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-6)
    lrs = [cfg.lr(k) for k in range(STEPS)]
    assert lrs[0] < lrs[1] < lrs[2]                       # the LR moves
    _check_state(states[0], j_states[0], init, lrs[0], 1e-3, freeze)
    _check_state(states[-1], j_states[-1], init, sum(lrs), 2e-4, freeze)
