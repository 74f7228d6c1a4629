"""The port's bf16 train policy against the JAX package's bf16 train step.

The slice is the train parity tests' (``tests/test_torch_train_model.py``):
``sa_npoints=(32, 16, 8, 8)``, B=2, N=128, 48x48 crops on the CPU, weights
carried from flax trees with nonzero SharedMLP dense biases, dropout off
on both sides. Both frameworks run their bf16 policy (JAX's XLA ops on the
CPU; the port's plain versions).

Two frameworks that round bf16 at different places cannot agree to a
float32 tolerance, so both are also held against a float64 step, the
port's: ``tests/test_torch_train_model.py`` and
``tests/test_torch_posenet_gt.py`` hold it to JAX's float64 step within
1.5e-7 of each output (measured here again: the port's float64 gradients
within 2.3e-7 of JAX's float64 gradients, normwise per tensor). Per
tensor, normwise (max |a - b| / max |float64|):

- the bf16 gap (port bf16 against JAX bf16) must be at most
  ``GAP_FACTOR`` = 2 times the larger of the two frameworks' own drifts
  (each bf16 step against the float64 step), for every output of the
  train branch and every gradient tensor. Measured, default recipe: the
  worst gradient tensor at 1.95x (``cam_enhancer.size_estimator.4.bias``:
  gap 5.3e-3, drifts 2.6e-3 / 2.7e-3), the worst output at 0.9x
  (``pred_translation``); PoseNetGT: 1.6x; frozen recipe (its gradients
  read from JAX's first Adam moment, ``mu / (1 - b1)``): 1.95x. The bf16
  drifts themselves reach O(1) of a tensor's largest gradient where that
  gradient is rounding noise (BN affines, PReLU slopes), in both
  frameworks alike;
- the loss parts within ``LOSS_RTOL`` = 2e-2 relative (measured <= 1.2e-3,
  ``feat``).

The Solver: 3 bf16 steps of the frozen recipe (the recipe of the shipped
bf16 config, ``config/ist_net_2048pt_dp.yaml``) over the synthetic trees
against JAX's ``make_train_step`` on the same batches: the losses within
2e-2 relative (measured <= 3.1e-3), and the parameters after step 3 leaf
by leaf. Adam's recipe eps (1e-8) turns every gradient element into a
step of ~lr whatever its size, so an element whose bf16 gradient is
rounding noise steps either way in either framework: leaf by leaf the
port's change is as far from JAX's (0.59 of JAX's change, l2 over all
leaves) as JAX's bf16 change is from the float64 one (0.62). The bound
is therefore held on the leaves that bf16 resolves, those whose JAX bf16
change lies within 10% of the float64 change (the port's float64 Solver,
held to JAX's in ``tests/test_torch_train_loop.py``): the worst of them
within ``LEAF_TOL`` = 0.5 of JAX's change, l2 (measured 0.18). A
skipped update reads 1.0 on every leaf, and the test plants it.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import test_torch_posenet_gt as PG
import test_torch_train_model as TM
from istnet_tpu.nn import layers as jax_layers
from istnet_tpu.nn import precision as jax_precision
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.entry import build_train_model, make_train_batch
from istnet_tpu_torch.models import losses
from istnet_tpu_torch.models.ist_net import ISTNet, gather_by_choose
from istnet_tpu_torch.models.ist_net import supervised_loss
from istnet_tpu_torch.models.posenet_gt import supervised_loss as pg_loss
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.train import train_state
from istnet_tpu_torch.train.solver import (
    Solver,
    concat_batches,
    split_batch,
    to_device,
)
from istnet_tpu_torch.train.train_state import (
    TrainConfig,
    batch_norms,
    make_optimizer,
    train_step,
)
from istnet_tpu_torch.utils import Config
from test_torch_train_loop import _loaders, _write_cfg, root  # noqa: F401

torch.set_num_threads(1)

GAP_FACTOR = 2.0
LOSS_RTOL = 2e-2
LEAF_TOL = 0.5
RESOLVED = 0.1          # a leaf's JAX bf16 change within this of float64's
POSE_KEYS = ("pred_rotation", "pred_translation", "pred_size")


@contextlib.contextmanager
def _policies(dtype):
    """The port under ``dtype``; JAX under bf16 when ``dtype`` is bf16;
    JAX's dropout off. Both policies restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers.Dropout2d, "__call__",
                   lambda self, x, train: x)
        if dtype == torch.bfloat16:
            jax_precision.set_compute_dtype(jnp.bfloat16)
        precision.set_compute_dtype(dtype)
        try:
            yield
        finally:
            jax_precision.set_compute_dtype(jnp.float32)
            precision.set_compute_dtype(torch.float32)


def _normwise(a, b, scale) -> float:
    return float((a - b).abs().max()) / max(scale, 1e-30)


def _check_gap(label, got, want, ref64):
    """Per tensor: |port bf16 - JAX bf16| <= GAP_FACTOR x the larger of
    the two bf16 drifts from ``ref64``; returns the worst ratio."""
    worst = (0.0, None)
    for k, r in ref64.items():
        scale = float(r.abs().max())
        if scale == 0.0:
            continue
        gap = _normwise(got[k], want[k], scale)
        drift = max(_normwise(got[k], r, scale), _normwise(want[k], r, scale))
        assert gap <= GAP_FACTOR * drift, (label, k, gap, drift)
        worst = max(worst, (gap / max(drift, 1e-30), k))
    return worst


def _jax_step(model, loss_fn, trees, batch, arch=None):
    """JAX's bf16 train branch, loss parts and gradients in one trace; the
    gradients in the port's keys."""
    def f(params, stats, inputs, labels):
        out, _ = model.apply({"params": params, "batch_stats": stats}, inputs,
                             train=True, mutable=["bn_batch"])
        total, parts = loss_fn(out, labels)
        return total, (parts, out)

    (_, (parts, out)), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        trees["params"], trees["batch_stats"], batch["inputs"],
        batch["labels"])
    return ({k: float(v) for k, v in parts.items()},
            {k: (torch.from_numpy(np.asarray(v, np.float64)), str(v.dtype))
             for k, v in out.items()},
            _grads_in_port_keys(jax.device_get(grads), trees, arch))


def _grads_in_port_keys(grads, trees, arch=None) -> dict:
    zeros = jax.tree_util.tree_map(np.zeros_like, trees["batch_stats"])
    args = () if arch is None else (arch,)
    return {k: v.double() for k, v in state_dict_from_jax(
        {"params": grads, "batch_stats": zeros}, *args).items()}


def _port_step(model, loss_fn, batch):
    """The port's forward, loss and backward: loss parts, outputs (with
    their dtypes) and gradients, float64."""
    t = TM._torch(batch)
    out = model(t["inputs"])
    total, parts = loss_fn(out, t["labels"])
    total.backward()
    return ({k: float(v) for k, v in parts.items()},
            {k: (v.detach().double(), str(v.dtype).replace("torch.", ""))
             for k, v in out.items()},
            {k: p.grad.double() for k, p in model.named_parameters()
             if p.grad is not None})


# ---------------------------------------------------------------------------
# The train branch and its gradients: default recipe and PoseNetGT
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["default", "posenet_gt"])
def branch(request):
    """JAX bf16, port bf16 and port float64 on one batch:
    ``(jax, port_bf16, port_f64)``, each ``(parts, outputs, grads)``."""
    if request.param == "posenet_gt":
        from istnet_tpu.models.posenet_gt import PoseNetGT as JaxModel
        from istnet_tpu.models.posenet_gt import supervised_loss as jax_loss
        trees, batch = PG._posenet_trees(seed=41), PG._batch(0)
        jm, arch = JaxModel(sa_npoints=TM.TINY), "posenet_gt"

        def port(dtype):
            return PG._port(trees, dtype)
        jloss, ploss = jax_loss, pg_loss
    else:
        from istnet_tpu.models.ist_net import ISTNet as JaxModel
        from istnet_tpu.models.ist_net import supervised_loss as jax_sl
        trees, batch = TM._trees(seed=21), TM._batch(0)
        jm, arch = JaxModel(sa_npoints=TM.TINY), None

        def jloss(e, lab):
            return jax_sl(e, lab, 8.0, 10.0, False)

        def ploss(e, lab):
            return supervised_loss(e, lab, 8.0, 10.0, False)

        def port(dtype):
            return TM._port(trees, False, dtype)
    with _policies(torch.bfloat16):
        want = _jax_step(jm, jloss, trees, batch, arch)
        got = _port_step(port(torch.float32), ploss, batch)
    with _policies(torch.float64):
        ref = _port_step(port(torch.float64), ploss, TM._to64(batch))
    return request.param, want, got, ref


def test_bf16_train_branch_and_loss_match_jax(branch):
    """Every train-mode output of the bf16 forward and every loss part,
    port against JAX; outputs in JAX's dtypes (float32 heads)."""
    name, (j_parts, j_out, _), (p_parts, p_out, _), (_, r_out, _) = branch
    assert set(p_out) == set(j_out) and set(p_parts) == set(j_parts)
    for k in j_out:
        assert p_out[k][1] == j_out[k][1], (k, p_out[k][1], j_out[k][1])
    _check_gap(name, {k: v for k, (v, _) in p_out.items()},
               {k: v for k, (v, _) in j_out.items()},
               {k: v for k, (v, _) in r_out.items()})
    for k, w in j_parts.items():
        assert abs(p_parts[k] - w) <= LOSS_RTOL * abs(w), (k, p_parts[k], w)


def test_bf16_gradients_match_jax(branch):
    """The gradient of every parameter, port bf16 against JAX bf16 within
    GAP_FACTOR of the larger bf16 drift; float32 on both sides."""
    name, (_, _, j_grads), (_, _, p_grads), (_, _, r_grads) = branch
    assert set(r_grads) == set(p_grads) and set(p_grads) <= set(j_grads)
    assert len(p_grads) > 100
    _check_gap(name, p_grads, j_grads, r_grads)


def test_pose_dis_sees_jax_dtypes_under_bf16(branch):
    """``pose_dis``'s inputs, the pose heads' outputs, are float32 under
    the bf16 policy in both frameworks (the labels are float32 batches)."""
    _, (_, j_out, _), (_, p_out, _), _ = branch
    keys = [k for k in j_out if k.startswith(POSE_KEYS)]
    assert keys
    for k in keys:
        assert j_out[k][1] == p_out[k][1] == "float32", k


def test_pose_dis_gradient_at_a_zero_difference_under_bf16():
    """Under the bf16 policy a pose equal to its label gives ``pose_dis``
    a gradient of exactly 0 on every parameter, not NaN (the double
    ``where`` of ``losses.norm_zero_subgrad``)."""
    precision.set_compute_dtype(torch.bfloat16)
    try:
        model = build_train_model("cpu", seed=7, sa_npoints=TM.TINY,
                                  dtype=torch.bfloat16)
        assert precision.compute_dtype() == torch.bfloat16
        batch = make_train_batch(2, 128, 48, seed=7, device="cpu")
        out = model(batch["inputs"], torch.Generator().manual_seed(0))
        total = 0.0
        for prefix in ("", "_aux_cam", "_aux_world"):
            pose = [out[k + prefix] for k in POSE_KEYS]
            assert all(p.dtype == torch.float32 for p in pose)
            total = total + losses.pose_dis(*pose, *(p.detach() for p in pose))
        total.backward()
    finally:
        precision.set_compute_dtype(torch.float32)
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert float(total.detach()) == 0.0 and grads
    assert all(torch.equal(g, torch.zeros_like(g)) for g in grads)


# ---------------------------------------------------------------------------
# The bf16 step's pieces
# ---------------------------------------------------------------------------

def test_gather_by_choose_bf16_backward_equals_jax():
    """At pixels chosen 3 times and more, the backward of the per-point
    gather under bf16 equals JAX's AD scatter-add of its row take bit for
    bit: both add the rows in bf16, in the points' order."""
    from istnet_tpu.models.ist_net import gather_by_choose as jax_gather

    rng = np.random.RandomState(0)
    fmap = rng.randn(2, 6, 6, 16).astype(np.float32)
    choose = rng.randint(0, 5, (2, 96)).astype(np.int32)    # ~19 a pixel
    cot = rng.randn(2, 96, 16).astype(np.float32)
    assert np.bincount(choose[0]).min() >= 3
    _, vjp = jax.vjp(lambda f: jax_gather(f, jnp.asarray(choose)),
                     jnp.asarray(fmap, jnp.bfloat16))
    want = np.asarray(vjp(jnp.asarray(cot, jnp.bfloat16))[0], np.float32)
    f = torch.from_numpy(fmap).bfloat16().requires_grad_()
    gather_by_choose(f, torch.from_numpy(choose)).backward(
        torch.from_numpy(cot).bfloat16())
    assert f.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(f.grad.float().numpy(), want)
    exact = np.zeros((2, 36, 16))
    for b in range(2):
        np.add.at(exact[b], choose[b], np.asarray(
            jnp.asarray(cot, jnp.bfloat16), np.float64)[b])
    # rows summed in bf16: a pixel of ~19 rows is a few bf16 ulps off
    assert 0 < np.abs(want.reshape(2, 36, 16) - exact).max() < 0.1


def test_resize_backward_rounds_once_per_contraction_under_bf16():
    """``_UpsampleBilinear``'s bf16 backward: two contractions, rows first,
    each accumulated in float32 and rounded once to bf16: within one bf16
    ulp of the float64 contractions rounded the same way (an accumulation
    in bf16 would be several ulps off)."""
    g = torch.from_numpy(np.random.RandomState(1).randn(2, 8, 24, 24)
                         ).bfloat16()
    x = torch.zeros(2, 8, 6, 6, dtype=torch.bfloat16, requires_grad=True)
    layers._UpsampleBilinear.apply(x, 24, 24).backward(g)
    ah = torch.from_numpy(layers._half_pixel_matrix(6, 24)).bfloat16().double()
    rows = torch.einsum("ih,ncij->nchj", ah, g.double()).bfloat16().double()
    want = torch.einsum("nchj,jw->nchw", rows, ah).bfloat16().double()
    ulp = 2.0 ** -7 * want.abs()
    assert x.grad.dtype == torch.bfloat16
    assert ((x.grad.double() - want).abs() <= ulp + 1e-30).all()


def test_bf16_step_keeps_float32_parameters_statistics_and_flags():
    """One bf16 train step: parameters, gradients, Adam's moments and
    every BN's published and running statistics stay float32; the
    activations a BN and a dropout return are bf16; the policy's backend
    flags are set (TF32 off, bf16 GEMM reductions in float32)."""
    cfg = TrainConfig()
    model = build_train_model("cpu", seed=2, sa_npoints=TM.TINY,
                              dtype=torch.bfloat16)
    opt = make_optimizer(model, cfg)
    seen = {}

    def spy(module, _, out):
        seen.setdefault(type(module).__name__, set()).add(out.dtype)
    hooks = [m.register_forward_hook(spy) for m in model.modules()
             if isinstance(m, (layers.BatchNorm, layers.Dropout2d))]
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    try:
        parts = train_step(model, opt,
                           make_train_batch(2, 128, 48, seed=2, device="cpu"),
                           0, torch.Generator().manual_seed(0), cfg)
        flags = (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cuda.matmul
                 .allow_bf16_reduced_precision_reduction)
    finally:
        precision.set_compute_dtype(torch.float32)
        for h in hooks:
            h.remove()
    assert flags == (False, False, False)
    assert seen == {"BatchNorm": {torch.bfloat16},
                    "Dropout2d": {torch.bfloat16}}
    assert all(torch.isfinite(v) and v.dtype == torch.float32
               for v in parts.values())
    for p in model.parameters():
        assert p.dtype == torch.float32
        assert p.grad is None or p.grad.dtype == torch.float32
    for state in opt.state.values():
        assert state["exp_avg"].dtype == state["exp_avg_sq"].dtype == \
            torch.float32
    for bn in batch_norms(model):
        assert bn.batch_mean.dtype == bn.batch_var.dtype == torch.float32
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32


def test_dropout2d_masks_in_the_activation_dtype():
    """Under bf16 the mask and its 1/keep scale are bf16, JAX's
    ``mask.astype(x.dtype) * asarray(1 / keep, x.dtype)``: every output is
    0 or the bf16 product of ``x`` and bf16(1/keep)."""
    drop = layers.Dropout2d(0.3).train()
    x = torch.randn(4, 3, 3, 64, generator=torch.Generator().manual_seed(0)
                    ).bfloat16()
    y = drop(x, torch.Generator().manual_seed(1))
    scale = torch.tensor(1 / 0.7).bfloat16()
    kept = y != 0
    assert y.dtype == torch.bfloat16 and 0 < kept.float().mean() < 1
    assert torch.equal(y[kept], (x * scale)[kept])


# ---------------------------------------------------------------------------
# The Solver under bf16: 3 steps of the frozen recipe
# ---------------------------------------------------------------------------

FROZEN_EDITS = (("freeze_world_enhancer: False", "freeze_world_enhancer: True"),
                ("gamma2: 10}", "gamma2: 100}"))


def _frozen_cfg(path):
    cfg = _write_cfg(path, 1, 3, compute_dtype="bfloat16")
    text = open(cfg).read()
    for old, new in FROZEN_EDITS:
        text = text.replace(old, new)
    open(cfg, "w").write(text)
    return cfg


def _solver(trees, cfg, data_dir, dtype, skip_update=False):
    """3 Solver steps from ``trees``: ``(losses, state, first-step
    gradients)``; the model float64 under the float64 policy."""
    model = ISTNet(sa_npoints=TM.TINY, freeze_world_enhancer=True)
    model.load_state_dict(state_dict_from_jax(trees), strict=True)
    model.to(torch.float64 if dtype == torch.float64 else torch.float32)
    model.train()
    for m in model.modules():
        if isinstance(m, layers.Dropout2d):
            m.eval()
    train_cfg = TrainConfig.from_config(cfg)
    opt = make_optimizer(model, train_cfg)
    grads = {}

    def first_grads(*args):
        if not grads:
            grads.update({k: p.grad.double() for k, p in
                          model.named_parameters() if p.grad is not None})
        real_finish(*args)
    real_finish = train_state.finish_step
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(train_state, "finish_step", first_grads)
        if skip_update:
            mp.setattr(opt, "step", lambda *a, **k: None)
        precision.set_compute_dtype(dtype)
        try:
            syn, real = _loaders(cfg, data_dir)
            solver = Solver(model, opt, train_cfg, cfg, syn_loader=syn,
                            real_loader=real)
            assert precision.compute_dtype() == dtype
            records = solver.solve()
        finally:
            precision.set_compute_dtype(torch.float32)
    state = {k: v.double() for k, v in model.state_dict().items()}
    return [r["total"] for r in records], state, grads


@pytest.fixture(scope="module")
def solver_runs(root, tmp_path_factory):  # noqa: F811
    """JAX's 3 bf16 steps (``make_train_step``) on the batches of the
    Solver's loaders, and the port's Solver under bf16, under bf16 with
    the update skipped, and under float64."""
    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet
    from istnet_tpu.models.ist_net import supervised_loss as jax_loss
    from istnet_tpu.train.train_state import (
        create_train_state,
        make_optimizer as jax_make_optimizer,
        make_train_step,
    )
    from istnet_tpu.utils.config import Config as JaxConfig

    path = _frozen_cfg(tmp_path_factory.mktemp("bf16_solver") / "c.yaml")
    cfg, data_dir = Config.fromfile(path), str(root / "data")
    trees = TM._trees(seed=51)
    syn, real = _loaders(cfg, data_dir)
    syn.dataset.reset()
    real.dataset.reset()
    batches = [split_batch(concat_batches(a, b))
               for a, b in zip(syn, real)]
    jcfg = JaxConfig.fromfile(path)
    with _policies(torch.bfloat16):
        tx, _ = jax_make_optimizer(jcfg, 3, trees["params"],
                                   frozen_prefix="world_enhancer")
        step = jax.jit(make_train_step(
            JaxISTNet(sa_npoints=TM.TINY, freeze_world_enhancer=True),
            lambda e, lab: jax_loss(e, lab, 1.0, 100.0, True), tx,
            jcfg.bn))
        state = create_train_state(trees["params"],
                                   trees["batch_stats"], tx)
        j_losses, j_parts = [], None
        for k, b in enumerate(batches):
            state, metrics = step(state, jax.tree_util.tree_map(
                jnp.asarray, b), jax.random.PRNGKey(k))
            j_losses.append(float(metrics["loss"]))
            if k == 0:
                # Adam's first moment after one step is (1 - b1) * g
                mu = optax.tree_utils.tree_get(state.opt_state, "mu")
                j_grads = jax.tree_util.tree_map(
                    lambda m, p: (np.zeros_like(p) if isinstance(
                        m, optax.MaskedNode) else np.asarray(m) / 0.1),
                    mu, trees["params"],
                    is_leaf=lambda m: isinstance(m, optax.MaskedNode))
                j_parts = {k2: float(v) for k2, v in metrics.items()}
    j_state = state_dict_from_jax(
        {"params": jax.device_get(state.params),
         "batch_stats": jax.device_get(state.batch_stats)})
    runs = {name: _solver(trees, cfg, data_dir, dtype, skip)
            for name, dtype, skip in (
                ("bf16", torch.bfloat16, False),
                ("skipped", torch.bfloat16, True),
                ("f64", torch.float64, False))}
    init = {k: v.double() for k, v in state_dict_from_jax(trees).items()}
    return {"jax": (j_losses, j_state, _grads_in_port_keys(j_grads, trees)),
            "jax_parts": j_parts, "init": init, **runs}


def test_bf16_frozen_gradients_match_jax(solver_runs):
    """The frozen recipe's first-step gradients (the world enhancer
    frozen, its features the target) under bf16, port against JAX within
    GAP_FACTOR of the larger bf16 drift."""
    _, _, j_grads = solver_runs["jax"]
    _, _, p_grads = solver_runs["bf16"]
    _, _, r_grads = solver_runs["f64"]
    assert set(p_grads) == set(r_grads)
    assert not any(k.startswith("world_enhancer.") for k in p_grads)
    _check_gap("frozen", p_grads, j_grads, r_grads)
    first = solver_runs["bf16"][0][0]
    assert abs(first - solver_runs["jax_parts"]["loss"]) <= LOSS_RTOL * first


def _leaf_gaps(state, j_state, r_state, init):
    """Per trained leaf whose JAX bf16 change bf16 resolves: the l2 gap
    of the port's change from JAX's, over JAX's change."""
    gaps = {}
    for k, v in state.items():
        if "running" in k or "num_batches" in k or ".feats.fc." in k:
            continue
        dj = j_state[k].double() - init[k]
        if float(dj.abs().max()) == 0.0:
            continue
        if float((dj - (r_state[k] - init[k])).norm()) > RESOLVED * float(
                dj.norm()):
            continue
        gaps[k] = float((v - init[k] - dj).norm()) / float(dj.norm())
    return gaps


def test_bf16_solver_steps_match_jax(solver_runs):
    """3 Solver steps under bf16: the losses against JAX's, the parameters
    after step 3 on every leaf bf16 resolves; a skipped update fails the
    same bound."""
    j_losses, j_state, _ = solver_runs["jax"]
    losses_, state, _ = solver_runs["bf16"]
    _, r_state, _ = solver_runs["f64"]
    init = solver_runs["init"]
    np.testing.assert_allclose(losses_, j_losses, rtol=LOSS_RTOL)
    gaps = _leaf_gaps(state, j_state, r_state, init)
    assert len(gaps) >= 20
    worst = max(gaps, key=gaps.get)
    print("resolved leaves", len(gaps), "worst", worst, gaps[worst])
    assert gaps[worst] <= LEAF_TOL, (worst, gaps[worst])
    skipped = _leaf_gaps(solver_runs["skipped"][1], j_state, r_state, init)
    assert min(skipped.values()) > LEAF_TOL
    assert any(state[k].ne(init[k]).any() for k in gaps)


def test_solver_sets_the_config_policy_and_keeps_inputs_float32():
    """A Solver on a bf16 config sets the bf16 policy; its inputs keep the
    parameters' float32 (the points are never cast to bf16); a float32
    config sets float32 back."""
    model = torch.nn.Linear(2, 2)
    cfg = TrainConfig()
    try:
        solver = Solver(model, make_optimizer(model, cfg), cfg,
                        Config({"max_epoch": 1, "compute_dtype": "bfloat16"}))
        assert precision.compute_dtype() == torch.bfloat16
        b = make_train_batch(2, 16, 8, seed=0, device="cpu")
        flat = {k: v.numpy() for part in b.values() for k, v in part.items()}
        batch = to_device(split_batch(flat), solver.device, solver.dtype)
        assert batch["inputs"]["pts"].dtype == torch.float32
        assert batch["labels"]["rotation_label"].dtype == torch.float32
        Solver(model, make_optimizer(model, cfg), cfg,
               Config({"max_epoch": 1, "compute_dtype": "float32"}))
        assert precision.compute_dtype() == torch.float32
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            Solver(model, make_optimizer(model, cfg), cfg,
                   Config({"max_epoch": 1, "compute_dtype": "float16"}))
    finally:
        precision.set_compute_dtype(torch.float32)


def test_profile_tool_attributes_the_bf16_step_by_module(monkeypatch,
                                                         capsys):
    """``tools/profile_train_torch.py --device cpu`` (the rehearsal of its
    device attribution, CPU self time in place of device time) on the bf16
    step: every program span shows up in its phase, each BN's backward
    under ``bn`` through the profiler's sequence numbers, Adam and the BN
    EMA under the update, and the casts the bf16 policy adds under their
    kind; the policy is float32 again after.
    """
    from pathlib import Path

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent
                                    / "tools"))
    import profile_train_torch

    try:
        assert profile_train_torch.main(
            ["--device", "cpu", "--dtype", "bfloat16", "--points", "128"]) == 0
    finally:
        precision.set_compute_dtype(torch.float32)
    rows = {tuple(line.split()[2:4]): line
            for line in capsys.readouterr().out.splitlines()
            if line.startswith("[by module] ") and " ms (" in line}
    for phase, owner in (("forward", "bn"), ("backward", "bn"),
                         ("forward", "psp"), ("backward", "up_1"),
                         ("forward", "sa1"), ("backward", "fp4"),
                         ("forward", "forward.world_enhancer"),
                         ("backward", "forward.cam_enhancer"),
                         ("forward", "step.loss"), ("update", "adam"),
                         ("update", "bn_ema")):
        assert (phase, owner) in rows, (phase, owner, sorted(rows))
    assert "casts" in rows[("backward", "bn")]
