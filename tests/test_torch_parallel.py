"""The port's data parallelism against the JAX package's, on the CPU.

Two ranks are two processes of a gloo group (``tests/torch_dp_worker.py``,
a ``file://`` rendezvous in the test's temporary directory), started once
for the module by ``parallel.multihost.spawn``; everything runs in float64
at the tiny model (SA npoints 32/16/8/8, N = 128, 48 x 48 crops) on a
global batch of B = 4, dropout off, weights bridged from JAX's trees as
``tests/test_torch_train_model.py`` bridges them.

- The global-batch BatchNorm across 2 ranks equals one process on the
  concatenated batch (outputs, published statistics, input and parameter
  gradients) to 1e-12 relative.
- The 2-rank DDP step (default recipe, frozen recipe, PoseNetGT) against
  JAX's ``jit_train_step_dp`` over a 2-device CPU mesh under x64: loss
  parts within 2e-6 relative, the updated state within the trajectory
  test's float64 bounds (``_check_state``), both ranks bit-equal; and
  against the port's one-process step on the whole batch to 1e-10.
- A group of one rank is bit-equal to no group; ``eval_forward_dp`` over
  two CPU replicas equals the unsplit forward; ``multihost.initialize`` is
  a no-op unconfigured and raises when a configured handshake fails.
"""

import datetime
import functools
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dp_worker
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.entry import build_model, make_inputs
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.parallel import mesh, multihost
from istnet_tpu_torch.train.train_state import (
    TrainConfig,
    make_optimizer,
    train_step,
)
from test_torch_posenet_gt import _posenet_trees
from test_torch_train_model import (
    BN_CFG,
    ITERS,
    MAX_EPOCH,
    _check_state,
    _jax_float64,
    _no_jax_dropout,
    _to64,
    _trees,
)

torch.set_num_threads(1)

TINY = (32, 16, 8, 8)
B, N, IMG = 4, 128, 48
WORLD = 2
RECIPES = {  # name -> (arch, freeze, seed of the trees)
    "default": ("ist_net", False, 61),
    "frozen": ("ist_net", True, 62),
    "posenet_gt": ("posenet_gt", False, 63),
}
BN_SHAPE = (4, 5, 3, 8)      # (B, ..., C): statistics over every axis but C


def _batch(seed: int) -> dict:
    """A float64 global batch of B rows; points spread at std 3 cm so that
    the camera radii find neighbours at 128 points (as in
    ``tests/test_torch_train_model.py::_batch``)."""
    rng = np.random.RandomState(seed)
    inputs = {
        "rgb": rng.randn(B, IMG, IMG, 3),
        "pts": rng.randn(B, N, 3) * 0.03,
        "choose": rng.randint(0, IMG * IMG, (B, N)).astype(np.int32),
        "category_label": (np.arange(B) * 2 + seed) % 6,
        "qo": (rng.rand(B, N, 3) - 0.5) * 0.4,
    }
    inputs["category_label"] = inputs["category_label"].astype(np.int32)
    labels = {
        "rotation_label": rng.randn(B, 3, 3),
        "translation_label": rng.randn(B, 3) * 0.1,
        "size_label": rng.rand(B, 3),
        "qo": inputs["qo"],
    }
    return {"inputs": inputs, "labels": labels}


def _torch(batch):
    return {part: {k: torch.from_numpy(v) for k, v in d.items()}
            for part, d in batch.items()}


def _train_cfg(arch: str, freeze: bool) -> TrainConfig:
    """The trajectory test's knobs (``tests/test_torch_train_model.py``)."""
    return TrainConfig(model_arch=arch, gamma1=8.0,
                       gamma2=100.0 if freeze else 10.0,
                       freeze_world_enhancer=freeze, max_epoch=MAX_EPOCH,
                       iters_per_epoch=ITERS, **BN_CFG)


@functools.lru_cache(maxsize=None)
def _recipe(name: str):
    """(trees, port state dict, config, global batch) of a recipe."""
    arch, freeze, seed = RECIPES[name]
    trees = _posenet_trees(seed) if arch == "posenet_gt" else _trees(seed)
    state = state_dict_from_jax(trees, arch)
    return trees, state, _train_cfg(arch, freeze), _batch(seed)


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The 2-rank jobs, all in one spawn: the BatchNorm's and one DDP step
    of each recipe. Returns the directory of the jobs' files and each
    rank's results."""
    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(3)
    torch.save({"x": torch.from_numpy(rng.randn(*BN_SHAPE) * 2.0 + 0.5),
                "cot": torch.from_numpy(rng.randn(*BN_SHAPE)),
                "weight": torch.from_numpy(1.0 + 0.1 * rng.randn(8)),
                "bias": torch.from_numpy(0.1 * rng.randn(8))}, tmp / "bn.pt")
    for name in RECIPES:
        _, state, cfg, batch = _recipe(name)
        arch, freeze, _ = RECIPES[name]
        torch.save({"arch": arch, "freeze": freeze, "state": state,
                    "cfg": cfg, "batch": _torch(batch)}, tmp / f"{name}.pt")
    results = multihost.spawn(torch_dp_worker.run, WORLD, str(tmp),
                              ["bn", *RECIPES], timeout=600)
    return tmp, results


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-300)
            ).item()


# ---------------------------------------------------------------------------
# The global-batch BatchNorm
# ---------------------------------------------------------------------------

def test_global_batch_norm_across_two_ranks_equals_one_process(dp_runs):
    tmp, results = dp_runs
    data = torch.load(tmp / "bn.pt")
    bn = layers.BatchNorm(BN_SHAPE[-1]).double().train()
    with torch.no_grad():
        bn.weight.copy_(data["weight"])
        bn.bias.copy_(data["bias"])
    x = data["x"].clone().requires_grad_()
    y = bn(x)
    (y * data["cot"]).sum().backward()
    ranks = [r["bn"] for r in results]
    assert _rel(torch.cat([r["y"] for r in ranks]), y.detach()) <= 1e-12
    assert _rel(torch.cat([r["x_grad"] for r in ranks]), x.grad) <= 1e-12
    for r in ranks:       # the global statistics, published on every rank
        assert _rel(r["mean"], bn.batch_mean) <= 1e-12
        assert _rel(r["var"], bn.batch_var) <= 1e-12
    # DDP sums the ranks' parameter gradients (and divides by the world)
    for name in ("weight_grad", "bias_grad"):
        want = getattr(bn, name.removesuffix("_grad")).grad
        assert _rel(sum(r[name] for r in ranks), want) <= 1e-12


def test_a_group_of_one_rank_is_bit_equal_to_no_group(tmp_path):
    """The BatchNorm and a whole DDP step (float32) over a gloo group of
    one rank give the bits of the single-process code."""
    from istnet_tpu_torch.entry import build_train_model, make_train_batch

    multihost.initialize("cpu", init_method=f"file://{tmp_path}/rdv",
                         rank=0, world_size=1)
    try:
        x = torch.randn(6, 5, 4, generator=torch.Generator().manual_seed(0))
        alone, grouped = layers.BatchNorm(4).train(), layers.BatchNorm(4).train()
        mesh.set_batch_norm_group(grouped, torch.distributed.group.WORLD)
        assert torch.equal(alone(x), grouped(x))
        assert torch.equal(alone.batch_var, grouped.batch_var)

        cfg = TrainConfig()
        states = []
        for wrap in (False, True):
            model = build_train_model("cpu", seed=5, sa_npoints=TINY)
            opt = make_optimizer(model, cfg)
            step_model = mesh.wrap_dp(model) if wrap else model
            parts = train_step(step_model, opt,
                               make_train_batch(2, N, IMG, seed=4, device="cpu"),
                               0, torch.Generator().manual_seed(1), cfg)
            states.append((parts, model.state_dict()))
    finally:
        multihost.shutdown()
    (p0, s0), (p1, s1) = states
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    assert list(s0) == list(s1)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)


# ---------------------------------------------------------------------------
# The DDP step
# ---------------------------------------------------------------------------

def _jax_dp_step(trees, arch: str, freeze: bool, batch: dict,
                 mesh_2d: tuple[int, int] | None = None):
    """One step of JAX's ``jit_train_step_dp`` over a 2-device CPU mesh
    under x64 (with ``mesh_2d = (dp, fsdp)``: ``jit_train_step_fsdp`` over
    ``make_mesh_2d(dp, fsdp)``): the metrics and the exported updated
    state."""
    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet
    from istnet_tpu.models.ist_net import supervised_loss as jax_loss
    from istnet_tpu.models.posenet_gt import PoseNetGT as JaxPoseNetGT
    from istnet_tpu.models.posenet_gt import supervised_loss as jax_pgt_loss
    from istnet_tpu.parallel import (jit_train_step_dp, jit_train_step_fsdp,
                                     make_mesh, make_mesh_2d, replicate,
                                     shard_batch, shard_batch_2d,
                                     shard_state_fsdp)
    from istnet_tpu.train.train_state import (
        create_train_state,
        make_optimizer as jax_make_optimizer,
        make_train_step,
    )
    from istnet_tpu.utils.config import Config

    cfg = _train_cfg(arch, freeze)
    with _jax_float64():
        params, stats = _to64(trees["params"]), _to64(trees["batch_stats"])
        jcfg = Config({"optimizer": {"name": "Adam", "lr": 1e-4,
                                     "weight_decay": 0.0},
                       "max_epoch": MAX_EPOCH, "bn": BN_CFG})
        tx, _ = jax_make_optimizer(
            jcfg, ITERS, params,
            frozen_prefix="world_enhancer" if freeze else None)
        if arch == "posenet_gt":
            model, loss = JaxPoseNetGT(sa_npoints=TINY), jax_pgt_loss
        else:
            model = JaxISTNet(sa_npoints=TINY, freeze_world_enhancer=freeze)

            def loss(e, lbl):
                return jax_loss(e, lbl, cfg.gamma1, cfg.gamma2, freeze)
        step_fn = make_train_step(model, loss, tx, jcfg.bn)
        state = create_train_state(params, stats, tx)
        batch = jax.tree_util.tree_map(jnp.asarray, batch)
        if mesh_2d is None:
            mesh_ = make_mesh(WORLD)
            step = jit_train_step_dp(step_fn, mesh_)
            state, batch = replicate(mesh_, state), shard_batch(mesh_, batch)
        else:
            mesh_ = make_mesh_2d(*mesh_2d)
            step = jit_train_step_fsdp(step_fn, mesh_, state)
            state = shard_state_fsdp(mesh_, state)
            batch = shard_batch_2d(mesh_, batch)
        state, metrics = step(state, batch, jax.random.PRNGKey(0))
        metrics = {k: float(v) for k, v in metrics.items()}
        return metrics, state_dict_from_jax(
            {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}, arch)


def _rank_outputs(tmp, name):
    return [torch.load(tmp / f"{name}_{r}.pt") for r in range(WORLD)]


@pytest.mark.parametrize("name", list(RECIPES))
def test_two_rank_step_matches_jax_dp_step(dp_runs, monkeypatch, name):
    tmp, _ = dp_runs
    _no_jax_dropout(monkeypatch)
    arch, freeze, _ = RECIPES[name]
    trees, state, cfg, batch = _recipe(name)
    metrics, j_state = _jax_dp_step(trees, arch, freeze, batch)
    r0, r1 = _rank_outputs(tmp, name)
    # both ranks bit-equal: averaged loss parts, the updated state
    assert all(torch.equal(r0["parts"][k], r1["parts"][k]) for k in r0["parts"])
    assert list(r0["state"]) == list(r1["state"])
    assert all(torch.equal(v, r1["state"][k]) for k, v in r0["state"].items())
    got = {k: float(v) for k, v in r0["parts"].items()}
    want = {("loss" if k == "total" else k): v for k, v in got.items()}
    for k, v in want.items():
        np.testing.assert_allclose(v, metrics[k], rtol=2e-6, err_msg=k)
    init = {k: v.double() if v.is_floating_point() else v
            for k, v in state.items()}
    _check_state(r0["state"], j_state, init, cfg.lr(0), 1e-3, freeze)


@pytest.mark.parametrize("name", list(RECIPES))
def test_two_rank_step_matches_the_one_process_step(dp_runs, name):
    tmp, _ = dp_runs
    assert_matches_one_process(_rank_outputs(tmp, name)[0], name)


def assert_matches_one_process(r0: dict, name: str) -> None:
    """A rank's step (``torch_dp_worker`` or ``torch_fsdp_worker``: the
    loss parts averaged over the ranks, the gradients and the updated
    state whole) against ``train_step`` on the whole batch in one process.
    The gradients (the ranks' average) normwise and the updated state per
    tensor within 1e-10 of the largest value (2 DDP ranks measured <=
    4.9e-13 and 5.1e-11); the loss parts within 1e-6 relative (measured
    1.3e-7): the feature and ``qo`` terms are float32 on both sides, as
    JAX's are, so the mean of the ranks' float32 means meets one float32
    mean of the batch only to float32 rounding. The per-tensor gradient is
    not a measure here: the RGB branch's conv biases before a train-mode
    BN have a gradient of 0 but for rounding."""
    arch, freeze, _ = RECIPES[name]
    _, state, cfg, batch = _recipe(name)
    precision.set_compute_dtype(torch.float64)
    try:
        model = torch_dp_worker.build(arch, freeze)
        model.load_state_dict(state, strict=True)
        opt = make_optimizer(model, cfg)
        parts = train_step(model, opt, _torch(batch), 0, torch.Generator(), cfg)
    finally:
        precision.set_compute_dtype(torch.float32)
    assert set(r0["parts"]) == set(parts)
    for k, v in parts.items():
        assert _rel(r0["parts"][k], v) <= 1e-6, k
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    assert set(r0["grads"]) == set(grads)
    scale = max(g.abs().max().item() for g in grads.values())
    for n, g in grads.items():
        assert (r0["grads"][n] - g).abs().max().item() <= 1e-10 * scale, n
    for k, v in model.state_dict().items():
        if v.is_floating_point():
            assert _rel(r0["state"][k], v) <= 1e-10, k
        else:
            assert torch.equal(r0["state"][k], v), k


# ---------------------------------------------------------------------------
# The data-parallel eval forward, the process group
# ---------------------------------------------------------------------------

def test_eval_forward_dp_over_two_cpu_replicas_equals_the_unsplit_forward():
    model = build_model("cpu", seed=2, sa_npoints=TINY)
    inputs = make_inputs(4, N, IMG, seed=3, device="cpu")
    forward = mesh.eval_forward_dp(model, ["cpu", "cpu"])
    with torch.inference_mode():
        want = model(inputs)
    got = forward({k: v.numpy() for k, v in inputs.items()})
    assert set(got) == set(want)
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="eval batch 3 must divide by the "
                                         "2-device mesh"):
        forward({k: v[:3] for k, v in inputs.items()})


def test_initialize_is_a_noop_without_a_launch(monkeypatch):
    for var in (*multihost.LAUNCH_VARS, "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.launch_env() is None
    assert multihost.initialize("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    assert multihost.per_host_batch_size(24) == 24
    multihost.barrier()                                   # no group: no-op
    with pytest.raises(ValueError, match="global batch 5 not divisible by "
                                         "2 hosts"):
        multihost.per_host_batch_size(5, 2)


def test_initialize_raises_when_a_configured_handshake_fails(monkeypatch):
    """torchrun's variables for rank 1 of 2 and a master port nobody
    serves: the handshake times out and raises (a pod run never degrades
    into independent runs); a half-configured launch raises too."""
    with socket.socket() as s:       # a free port on this host, then closed
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
           "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises((RuntimeError, TimeoutError)):
        multihost.initialize("cpu", timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("MASTER_PORT")
    with pytest.raises(RuntimeError, match="MASTER_PORT"):
        multihost.initialize("cpu")
