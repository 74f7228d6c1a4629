"""The port's training loop on the device input pipeline
(``config/ist_net_device_pipeline.yaml``: raw frames from the datasets,
the rest inside the step) against the JAX package, and its CLI end to end.

On the CPU at the tiny model (SA npoints 32/16/8/8, B = 2 + 2, N = 128,
48 x 48 crops) over the port's synthetic train trees, as
``tests/test_torch_train_loop.py`` holds the host path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.entry import build_model
from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.train.solver import Solver, concat_batches
from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
from istnet_tpu_torch.utils import Config
from test_torch_train_cli import quiet_logger  # noqa: F401
from test_torch_train_loop import (  # noqa: F401
    IMG,
    NPTS,
    TINY,
    TINY_CFG,
    _loaders,
    _set_dense_biases,
    root,
)
from test_torch_train_model import _jax_float64

torch.set_num_threads(1)
# a leaf's change over the 3 steps, of its largest element (measured 1.03e-5)
UPDATE_RTOL = 3e-5
# changes below this are rounding noise of a gradient that is 0 in exact
# arithmetic (the unused fc, biases before a train-mode BN)
NOISE = 1e-12


DEVICE_PIPELINE = {"use_shape_aug: True": "use_shape_aug: False",
                   "use_device_aug: False": "use_device_aug: True\n"
                                            "  use_device_preprocess: True",
                   "aug_bb_pro: 0.3": "aug_bb_pro: 0.5",
                   "aug_rt_pro: 0.3": "aug_rt_pro: 0.5",
                   "weight_decay: 0}": "weight_decay: 0, adam_eps: 0.001}"}


def write_device_pipeline_cfg(path, max_epoch, iters):
    """``TINY_CFG`` on the device input pipeline (the gates at 0.5)."""
    text = TINY_CFG.format(max_epoch=max_epoch, iters=iters, img=IMG, pts=NPTS)
    for old, new in DEVICE_PIPELINE.items():
        assert old in text
        text = text.replace(old, new)
    path.write_text(text)
    return str(path)


def test_solver_device_pipeline_losses_match_jax_train_step(root, tmp_path,
                                                            monkeypatch):
    """3 Solver steps on the device input pipeline (raw frames; the fill,
    crop, sampling, jitter, ColorJitter, ``qo`` and the box stretch and
    rigid motion inside the step) against JAX's ``make_train_step`` with
    ``augment_fn=device_augment`` and JAX's ``make_train_preprocess`` on
    the same raw batches, dropout off on both sides. The port takes JAX's
    draws of each step through its ``draw_*`` functions.

    The model runs in float64 on both sides (JAX's float32 train forward
    is ill-conditioned, ``tests/test_torch_train_model.py``), the
    preprocessing in float32 on both: JAX's does not trace under x64 (a
    Python 0 among its int32 ``dynamic_slice`` starts becomes int64), so it
    runs first, with the step's key, on each raw batch, and the step's
    ``preprocess_fn`` hands its result on; the key splits of the step stay
    JAX's. The pipelines agree to 1e-6 m in the points and 2e-3 of a level
    in the colours (``tests/test_torch_device_train.py``), and training
    amplifies that in proportion to the LR: at the recipe's 1e-3 at step 1
    the losses parted by 2.2e-4 at step 2 (measured; 7.5e-7 at step 1,
    after an update at 1e-5). So the cyclic LR runs its first steps here
    (max_epoch 600: 1e-5, 1.3e-5, 1.7e-5) and Adam's eps is 1e-3, which
    keeps the updates of elements whose gradients are rounding noise
    proportional to them rather than +-lr. The losses are held to rtol
    2e-6, the host path's bound (measured 6e-8, 7.5e-7, 1.1e-6).

    At these LRs an update barely moves the loss, so the losses hold the
    pipeline (step 0 above all) but not the updates. The updates are held
    leaf by leaf: a second Solver run takes JAX's preprocessed batches
    through its ``preprocess_fn`` (the port's augmentation, forward,
    backward and Adam stay), and each parameter's and BN statistic's change
    over the 3 steps matches JAX's within ``UPDATE_RTOL`` of the leaf's
    largest change. On the port's own pipeline the 1e-6 m input difference
    moves some leaves' changes by up to 45%, so that run is not held so.
    Measured: a skipped update gives 1.0, a dropped augmentation 2.0."""
    from istnet_tpu.data import device_augment as jda
    from istnet_tpu.data import device_preprocess as jdp
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
    from istnet_tpu_torch.data import device_augment as da
    from istnet_tpu_torch.data import device_preprocess as dp
    from istnet_tpu_torch.data import device_transforms as dt
    from test_torch_device_train import jax_augment_draws, jax_preprocess_draws

    monkeypatch.setattr(jl.Dropout2d, "__call__", lambda self, x, train: x)
    path = write_device_pipeline_cfg(tmp_path / "c.yaml", 600, 3)
    cfg = Config.fromfile(path)
    data_dir = str(root / "data")
    src = build_model(sa_npoints=TINY, seed=52, device="cpu")
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(52))

    syn, real = _loaders(cfg, data_dir)
    syn.dataset.reset()
    real.dataset.reset()
    raws = [concat_batches(a, b) for a, b in zip(syn, real)]
    assert len(raws) == 3 and raws[0]["depth_raw"].shape == (4, 480, 640)
    # the step's keys: preprocessing, then augmentation (train_state.py)
    keys = [jax.random.split(jax.random.PRNGKey(k)) for k in range(3)]
    keys = [(pre, jax.random.split(rest)[0]) for pre, rest in keys]
    jpre = jdp.make_train_preprocess(IMG, NPTS)
    pres = [jpre({k: jnp.asarray(v) for k, v in raw.items()}, pre)
            for raw, (pre, _) in zip(raws, keys)]
    pre_draws = [jax_preprocess_draws(pre, 4, NPTS) for pre, _ in keys]

    jcfg = JaxConfig.fromfile(path)
    with _jax_float64():
        aug_draws = [jax_augment_draws(aug, 4) for _, aug in keys]
        to64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64)
            if np.asarray(a).dtype == np.float32 else jnp.asarray(a), t)
        params, stats = to64(trees["params"]), to64(trees["batch_stats"])
        tx, _ = jax_make_optimizer(jcfg, 3, params)
        step = jax.jit(make_train_step(
            JaxISTNet(sa_npoints=TINY),
            lambda e, lab: jax_loss(e, lab, 1.0, 10.0, False), tx, jcfg.bn,
            augment_fn=lambda batch, rng: jda.device_augment(batch, rng,
                                                             0.5, 0.5),
            preprocess_fn=lambda preprocessed, rng: preprocessed))
        state = create_train_state(params, stats, tx)
        want = []
        for k, pre in enumerate(pres):
            state, metrics = step(state, to64(pre), jax.random.PRNGKey(k))
            want.append(float(metrics["loss"]))

    def run_port(preprocessed=None):
        """3 Solver steps from the converted weights; with
        ``preprocessed``, the step's preprocessing hands on those batches."""
        for module, name, seq in ((dp, "draw_preprocess", pre_draws),
                                  (dt, "draw_color_jitter",
                                   [d["color"] for d in pre_draws]),
                                  (da, "draw_augment", aug_draws)):
            monkeypatch.setattr(module, name,
                                lambda *a, _it=iter(seq), **kw: next(_it))
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
            solver = Solver(model, make_optimizer(model, train_cfg),
                            train_cfg, cfg, syn_loader=syn, real_loader=real)
            if preprocessed is not None:
                batches = iter(preprocessed)
                solver.preprocess_fn = lambda raw, generator: next(batches)
            records = solver.train_epoch(1)
        finally:
            precision.set_compute_dtype(torch.float32)
        return records, model.state_dict()

    records, _ = run_port()
    assert [r["step"] for r in records] == [0, 1, 2]
    assert records[0]["lr"] < records[1]["lr"] < records[2]["lr"] < 2e-5
    np.testing.assert_allclose([r["total"] for r in records], want, rtol=2e-6)

    # the 3 updates, leaf by leaf (parameters and BN statistics): the port's
    # step on JAX's preprocessed batches against JAX's step
    to_torch64 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: torch.from_numpy(np.asarray(
            a, np.float64 if np.asarray(a).dtype == np.float32 else None)), t)
    _, got = run_port([to_torch64(pre) for pre in pres])
    before = state_dict_from_jax({"params": params, "batch_stats": stats})
    delta = state_dict_from_jax(jax.tree_util.tree_map(
        lambda a, b: np.asarray(a - b),
        {"params": state.params, "batch_stats": state.batch_stats},
        {"params": params, "batch_stats": stats}))
    worst = 0.0
    for k, d_want in delta.items():
        if not d_want.is_floating_point():
            continue
        d_got = got[k] - before[k]
        if d_want.abs().max() < NOISE:
            assert d_got.abs().max() < NOISE, k
            continue
        err = float((d_got - d_want).abs().max() / d_want.abs().max())
        worst = max(worst, err)
    assert worst < UPDATE_RTOL, worst


def test_cli_train_runs_the_device_pipeline_config(root, tmp_path,
                                                   quiet_logger):
    """``cli/train.py --config`` on a copy of
    ``config/ist_net_device_pipeline.yaml`` cut to the tiny model and 2
    epochs of 2 steps: raw batches, finite losses, and a warning when the
    host augmentation is asked for beside the device one."""
    import logging
    from pathlib import Path

    import yaml

    from istnet_tpu_torch.cli import train as cli_train

    repo = Path(__file__).resolve().parent.parent
    cfg = yaml.safe_load((repo / "config" / "ist_net_device_pipeline.yaml")
                         .read_text())
    cfg.update(max_epoch=2, num_mini_batch_per_epoch=2, per_write=1,
               sa_npoints=list(TINY))
    cfg["train_dataset"].update(img_size=IMG, sample_num=NPTS)
    cfg["train_dataloader"].update(syn_bs=2, real_bs=2, num_workers=2)
    path = tmp_path / "device_pipeline.yaml"
    path.write_text(yaml.safe_dump(cfg))
    data = ["--data_dir", str(root / "data"), "--device", "cpu"]
    solver = cli_train.main(["--config", str(path), "--log_dir",
                             str(tmp_path / "log")] + data)
    assert solver.preprocess_fn is not None and solver.augment_fn is not None
    assert [r["step"] for r in solver.records] == [0, 1, 2, 3]
    assert all(np.isfinite(r["total"]) for r in solver.records)

    cfg["train_dataset"].update(use_shape_aug=True, use_device_preprocess=False)
    cfg["max_epoch"] = 1
    path.write_text(yaml.safe_dump(cfg))
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("istnet").addHandler(handler)
    cli_train.main(["--config", str(path), "--log_dir",
                    str(tmp_path / "log2")] + data)
    assert any("augmented twice" in r.getMessage() for r in records)
