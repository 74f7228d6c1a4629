"""The port's training loop against the JAX package, and its CLIs end to end.

On the CPU at the tiny model (SA npoints 32/16/8/8, B = 2 + 2, N = 128,
48 x 48 crops) over the port's synthetic train trees:

- ``TrainConfig.from_config`` of every ``config/*.yaml`` against what JAX's
  ``make_optimizer`` reads (the LR schedule and three Adam updates);
- the ``Solver``'s per-step losses over 3 steps against JAX's
  ``make_train_step`` fed the same ``split_batch(concat_batches(...))``
  batches, float64 on both sides, dropout off, as
  ``tests/test_torch_train_model.py`` holds the trajectory (2e-6);
- a checkpoint round trip (bit-equal, also restored with
  ``map_location="cpu"``).

``tests/test_torch_train_cli.py`` drives the CLIs over the same trees.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu.data import depth_utils as jax_depth_utils
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.data import depth_utils as port_depth_utils
from istnet_tpu_torch.data import synthetic
from istnet_tpu_torch.data.dataset import TrainingDataset
from istnet_tpu_torch.data.loader import DataLoader
from istnet_tpu_torch.entry import build_model
from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.train.solver import Solver, concat_batches, split_batch
from istnet_tpu_torch.train.train_state import (
    TrainConfig,
    make_optimizer,
    train_step,
)
from istnet_tpu_torch.utils import Config

torch.set_num_threads(1)

TINY = (32, 16, 8, 8)
IMG, NPTS = 48, 128
CONFIGS = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
    "*.yaml")))

TINY_CFG = """\
model_arch: ist_net
freeze_world_enhancer: False
sa_npoints: [32, 16, 8, 8]
optimizer: {{name: Adam, lr: 0.01, betas: [0.5, 0.999], eps: 0.000001, weight_decay: 0}}
bn: {{bn_momentum: 0.9, bn_decay: 0.5, decay_step: 2, bnm_clip: 0.01}}
max_epoch: {max_epoch}
num_mini_batch_per_epoch: {iters}
num_category: 6
loss: {{gamma1: 1.0, gamma2: 10}}
train_dataset:
  img_size: {img}
  sample_num: {pts}
  shift_range: 0.01
  use_shape_aug: True
  use_device_aug: False
  aug_bb_pro: 0.3
  aug_rt_pro: 0.3
  aug_bc_pro: 0.0
  aug_pc_pro: 0.0
  aug_pc_r: 0.002
  aug_nl_pro: 0.0
train_dataloader:
  syn_bs: 2
  real_bs: 2
  num_workers: 2
  shuffle: True
  drop_last: True
  use_fill_miss: True
  use_composed_img: True
  per_obj: ''
test:
  img_size: {img}
  sample_num: {pts}
rd_seed: 1
per_write: 2
compute_dtype: float32
"""


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """Train trees under ``root/data`` (the composed-depth path needs a
    ``/data/`` dir) and a test tree under ``root``."""
    root = tmp_path_factory.mktemp("train_loop")
    synthetic.build_train_trees(str(root / "data"), n_scenes=3)
    synthetic.build_test_tree(str(root), n_scenes=2)
    return root


def _write_cfg(path, max_epoch, iters, **extra):
    text = TINY_CFG.format(max_epoch=max_epoch, iters=iters, img=IMG, pts=NPTS)
    for k, v in extra.items():
        text = text.replace(f"{k}: ", f"{k}: {v}  # ", 1) if f"{k}: " in text \
            else text + f"{k}: {v}\n"
    path.write_text(text)
    return str(path)


# ---------------------------------------------------------------------------
# TrainConfig.from_config
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_train_config_from_yaml_matches_jax_make_optimizer(path):
    """The LR schedule at steps across a cycle, the BN momentum and three
    Adam updates of a trainable and a ``world_enhancer`` parameter against
    JAX's ``make_optimizer`` of the same file (with its frozen prefix when
    the file freezes the world enhancer), float32 on both sides: the LR
    and the momentum equal, the parameters within one ulp."""
    import optax

    from istnet_tpu.train.schedules import bn_momentum
    from istnet_tpu.train.train_state import make_optimizer as jax_optimizer
    from istnet_tpu.utils.config import Config as JaxConfig

    cfg = TrainConfig.from_config(Config.fromfile(path))
    jcfg = JaxConfig.fromfile(path)
    iters = int(jcfg.get("num_mini_batch_per_epoch", 4000))
    freeze = (jcfg.get("model_arch", "ist_net") == "ist_net"
              and bool(jcfg.get("freeze_world_enhancer", False)))
    assert cfg.freeze_world_enhancer == freeze
    assert cfg.model_arch == jcfg.get("model_arch", "ist_net")
    assert cfg.iters_per_epoch == iters and cfg.max_epoch == jcfg.max_epoch
    loss = jcfg.get("loss") or {}
    assert cfg.gamma1 == float(loss.get("gamma1", 1.0))
    assert cfg.gamma2 == float(loss.get("gamma2", 10.0))

    rng = np.random.RandomState(7)
    w0 = {"a": rng.randn(6).astype(np.float32),
          "world_enhancer": rng.randn(6).astype(np.float32)}
    grads = [{k: (rng.randn(6) * 1e-3).astype(np.float32) for k in w0}
             for _ in range(3)]
    tx, lr_schedule = jax_optimizer(
        jcfg, iters, {k: jnp.asarray(v) for k, v in w0.items()},
        frozen_prefix="world_enhancer" if freeze else None)
    for step in (0, 1, 3, 7777, cfg.step_size_up, 2 * cfg.step_size_up + 5):
        assert cfg.lr(step) == float(lr_schedule(step)), step
        assert cfg.momentum(step) == float(bn_momentum(
            step, float(jcfg.bn.bn_momentum), float(jcfg.bn.bn_decay),
            int(jcfg.bn.decay_step), float(jcfg.bn.bnm_clip))), step
    params = {k: jnp.asarray(v) for k, v in w0.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
        params = optax.apply_updates(params, updates)

    module = torch.nn.Module()
    for k, v in w0.items():
        setattr(module, k, torch.nn.Linear(6, 1, bias=False))
        with torch.no_grad():
            getattr(module, k).weight.copy_(torch.from_numpy(v)[None])
    opt = make_optimizer(module, cfg)
    for step, g in enumerate(grads):
        for group in opt.param_groups:
            group["lr"] = cfg.lr(step)
        for k, v in g.items():
            getattr(module, k).weight.grad = torch.from_numpy(v)[None].clone()
        opt.step()
    for k in w0:
        # the two Adams round their last operation apart: one float32 ulp
        # of the parameter at most
        got = getattr(module, k).weight.detach()[0].numpy()
        want = np.asarray(params[k])
        assert (np.abs(got - want) <= np.spacing(np.abs(want))).all(), k
        moved = np.abs(want - w0[k]).max()
        if freeze and k == "world_enhancer":
            assert moved == 0 and np.array_equal(got, w0[k])
        else:
            assert moved > 0


# ---------------------------------------------------------------------------
# The Solver against JAX's train step
# ---------------------------------------------------------------------------

def _set_dense_biases(tree, rng, inside=False):
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if inside and k == "Dense_0":
            v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
        else:
            _set_dense_biases(v, rng, inside or k.startswith("SharedMLP"))


def _loaders(cfg, data_dir):
    """The two loaders ``cli/train.py`` builds from ``cfg``."""
    dl, iters = cfg.train_dataloader, int(cfg.num_mini_batch_per_epoch)
    out = []
    raw = bool(cfg.train_dataset.get("use_device_preprocess", False))
    for data_type, bs, seed in (("syn", int(dl.syn_bs), 1),
                                ("real_withLabel", int(dl.real_bs), 2)):
        ds = TrainingDataset(cfg.train_dataset, data_dir, data_type=data_type,
                             num_img_per_epoch=iters * bs, seed=seed,
                             device_preprocess=raw)
        out.append(DataLoader(ds, bs, num_workers=int(dl.num_workers)))
    return out


def test_solver_losses_match_jax_train_step(root, tmp_path, monkeypatch):
    """3 Solver steps (one epoch of 3 iterations; the LR's half period is
    1 step and the BN momentum decays every 2) against JAX's
    ``make_train_step`` + ``make_optimizer`` fed the batches of the same
    loaders, float64 on both sides, dropout off on both."""
    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet
    from istnet_tpu.models.ist_net import supervised_loss as jax_loss
    from istnet_tpu.nn import layers as jl
    from istnet_tpu.nn import precision as jprecision
    from istnet_tpu.train.train_state import (
        create_train_state,
        make_optimizer as jax_make_optimizer,
        make_train_step,
    )
    from istnet_tpu.utils.config import Config as JaxConfig

    monkeypatch.setattr(jl.Dropout2d, "__call__", lambda self, x, train: x)
    monkeypatch.setattr(jax_depth_utils, "_NATIVE_OK", False)
    monkeypatch.setattr(port_depth_utils, "_NATIVE_OK", False)
    cfg = Config.fromfile(_write_cfg(tmp_path / "c.yaml", 1, 3))
    data_dir = str(root / "data")
    src = build_model(sa_npoints=TINY, seed=51, device="cpu")
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(51))

    # the JAX side: the same loaders' batches, resampled as the epoch does
    syn, real = _loaders(cfg, data_dir)
    syn.dataset.reset()
    real.dataset.reset()
    batches = [split_batch(concat_batches(a, b)) for a, b in zip(syn, real)]
    assert len(batches) == 3
    jcfg = JaxConfig.fromfile(str(tmp_path / "c.yaml"))
    jax.config.update("jax_enable_x64", True)
    jprecision.set_compute_dtype(np.float64)
    try:
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64)
            if np.asarray(a).dtype == np.float32 else jnp.asarray(a), t)
        params, stats = to64(trees["params"]), to64(trees["batch_stats"])
        tx, _ = jax_make_optimizer(jcfg, 3, params)
        step = jax.jit(make_train_step(
            JaxISTNet(sa_npoints=TINY),
            lambda e, lab: jax_loss(e, lab, 1.0, 10.0, False), tx, jcfg.bn))
        state = create_train_state(params, stats, tx)
        want = []
        for k, b in enumerate(batches):
            state, metrics = step(state, to64(b), jax.random.PRNGKey(k))
            want.append(float(metrics["loss"]))
    finally:
        jax.config.update("jax_enable_x64", False)
        jprecision.set_compute_dtype(np.float32)

    precision.set_compute_dtype(torch.float64)
    try:
        model = ISTNet(sa_npoints=TINY)
        model.load_state_dict(state_dict_from_jax(trees), strict=True)
        model.to(torch.float64).train()
        for m in model.modules():
            if isinstance(m, layers.Dropout2d):
                m.eval()
        train_cfg = TrainConfig.from_config(cfg)
        syn, real = _loaders(cfg, data_dir)
        solver = Solver(model, make_optimizer(model, train_cfg), train_cfg,
                        cfg, syn_loader=syn, real_loader=real)
        records = solver.solve()
    finally:
        precision.set_compute_dtype(torch.float32)
    assert [r["step"] for r in records] == [0, 1, 2] and solver.step == 3
    assert [r["lr"] for r in records] == [train_cfg.lr(k) for k in range(3)]
    assert records[0]["lr"] < records[1]["lr"]
    np.testing.assert_allclose([r["total"] for r in records], want, rtol=2e-6)
    for r in records:
        assert r["T_iter"] >= r["T_data"] + r["T_dispatch"] > 0


def test_solver_refuses_what_is_not_ported(root):
    """FSDP over more devices than a single process has, and the device
    augmentation with a host-only augmentation (box cage, point noise,
    non-linear), raise the JAX package's ValueErrors (the first is the
    counterpart of ``tests/test_fsdp.py:243``)."""
    model = torch.nn.Linear(2, 2)
    cfg = TrainConfig()
    opt = make_optimizer(model, cfg)
    with pytest.raises(ValueError, match="exceeds the 1 available devices"):
        Solver(model, opt, cfg, Config({"max_epoch": 1,
                                         "parallel": {"fsdp": 4}}))
    for k in ("aug_bc_pro", "aug_pc_pro", "aug_nl_pro"):
        td = {"use_device_aug": True, k: 0.5}
        with pytest.raises(ValueError, match=f"only bb/rt augs; {k} > 0"):
            Solver(model, opt, cfg, Config({"max_epoch": 1,
                                             "train_dataset": td}))


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------

def _assert_state_equal(a, b):
    """Nested state dicts equal: tensors bit for bit, in the same dtype."""
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b) and a.dtype == b.dtype
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_state_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_state_equal(x, y)
    else:
        assert a == b


def test_checkpoint_round_trip_is_bit_equal(tmp_path):
    cfg = TrainConfig(decay_step=1)
    model = build_model(sa_npoints=TINY, seed=8, device="cpu").train()
    opt = make_optimizer(model, cfg)
    from istnet_tpu_torch.entry import make_train_batch
    train_step(model, opt, make_train_batch(2, NPTS, IMG, seed=4, device="cpu"),
               0, torch.Generator().manual_seed(0), cfg)
    ckpt = str(tmp_path / "ckpt")
    assert checkpoints.latest_epoch(ckpt) is None
    for epoch in (5, 10):
        checkpoints.save_checkpoint(ckpt, epoch, model, opt, 7 + epoch,
                                    extra_meta={"note": "x"})
    assert checkpoints.latest_epoch(ckpt) == 10
    assert sorted(os.listdir(ckpt)) == ["10", "5"]

    fresh = build_model(sa_npoints=TINY, seed=9, device="cpu").train()
    fresh_opt = make_optimizer(fresh, cfg)
    payload = checkpoints.restore_checkpoint(ckpt, 5, fresh, fresh_opt)
    assert payload["step"] == 12 and payload["meta"] == {"epoch": 5, "note": "x"}
    _assert_state_equal(fresh.state_dict(), model.state_dict())
    _assert_state_equal(fresh_opt.state_dict(), opt.state_dict())
    evald = checkpoints.restore_for_eval(ckpt, 5, map_location="cpu")
    _assert_state_equal(evald["model"], model.state_dict())
    with pytest.raises(FileNotFoundError, match="epoch 6"):
        checkpoints.restore_for_eval(ckpt, 6)


def test_log_buffer_and_metric_writer_match_jax(tmp_path, monkeypatch):
    """``LogBuffer``'s running averages equal the JAX package's over the
    same updates, and ``clear`` starts a new window; ``MetricWriter`` is a
    no-op without tensorboardX, as in JAX."""
    import sys

    from istnet_tpu.utils import logging as jax_logging
    from istnet_tpu_torch.utils.logging import LogBuffer, MetricWriter

    got, want = LogBuffer(), jax_logging.LogBuffer()
    rng = np.random.RandomState(3)
    for _ in range(2):
        for _ in range(5):
            update = {"loss": float(rng.rand()), "T_iter": float(rng.rand())}
            if rng.rand() < 0.5:
                update["aux"] = float(rng.rand())
            got.update(update)
            want.update(update)
        assert got.average() == want.average()
        got.clear()
        want.clear()
        assert got.average() == want.average() == {}
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    writer = MetricWriter(str(tmp_path))
    writer.add_scalars("train/", {"loss": 1.0}, 3)
    writer.close()
    assert list(tmp_path.iterdir()) == []
