"""The port's training CLIs end to end on the CPU at the tiny model (SA
npoints 32/16/8/8, B = 2 + 2, N = 128, 48 x 48 crops) over the port's
synthetic train and test trees: ``cli/train.py`` trained, resumed from its
checkpoint (state bit-equal to the saved one; step, epoch and LR continue)
and tested by ``cli/test.py`` from that checkpoint; then
``cli/two_phase_smoke.py`` at its tiny defaults.
"""

import glob
import logging
import os

import numpy as np
import pytest
import torch

from istnet_tpu_torch.cli import convert_torch_resnet
from istnet_tpu_torch.entry import random_resnet_state_dict
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
from istnet_tpu_torch.utils import Config
from test_torch_train_loop import _assert_state_equal, _write_cfg, root  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture
def quiet_logger():
    """``get_logger`` keeps its first handlers per process: drop them after
    each CLI run, so that a test's log file does not outlive it."""
    yield
    logger = logging.getLogger("istnet")
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()


def test_cli_train_resume_and_test_from_its_checkpoint(root, tmp_path,
                                                       quiet_logger):
    """``cli/train.py`` trains 5 epochs of 2 iterations and writes the
    epoch-5 checkpoint; ``--checkpoint_epoch 5`` with ``max_epoch`` 6
    restores it (model and optimizer bit-equal to the saved state) and runs
    epoch 6 from step 10 at ``TrainConfig.lr(10)``; ``cli/test.py`` then
    restores epoch 5 without ``--torch_checkpoint`` and gives finite APs.
    ``--pretrained_backbone`` trains from a converted trunk; ``--devices 2``
    trains over two CPU ranks; a ``compute_dtype: bfloat16`` config trains
    under the bf16 policy."""
    from istnet_tpu_torch.cli import test as cli_test
    from istnet_tpu_torch.cli import train as cli_train

    log_dir = str(tmp_path / "log")
    data = ["--data_dir", str(root / "data"), "--log_dir", log_dir,
            "--device", "cpu"]
    cfg5 = _write_cfg(tmp_path / "c5.yaml", 5, 2)
    solver = cli_train.main(["--config", cfg5] + data)
    records = solver.records
    assert [r["step"] for r in records] == list(range(10))
    assert all(np.isfinite(r["total"]) for r in records)
    assert checkpoints.latest_epoch(os.path.join(log_dir, "ckpt")) == 5
    saved = checkpoints.restore_for_eval(os.path.join(log_dir, "ckpt"), 5)
    assert saved["step"] == 10 and saved["meta"]["epoch"] == 5
    _assert_state_equal(saved["model"], solver.model.state_dict())
    _assert_state_equal(saved["optimizer"], solver.optimizer.state_dict())

    cfg6 = _write_cfg(tmp_path / "c6.yaml", 6, 2)
    train_cfg = TrainConfig.from_config(Config.fromfile(cfg6))
    model = cli_train.build_model(Config.fromfile(cfg6), train_cfg).train()
    opt = make_optimizer(model, train_cfg)
    checkpoints.restore_checkpoint(os.path.join(log_dir, "ckpt"), 5, model, opt)
    _assert_state_equal(model.state_dict(), saved["model"])
    _assert_state_equal(opt.state_dict(), saved["optimizer"])
    resumed = cli_train.main(["--config", cfg6, "--checkpoint_epoch", "5"]
                             + data).records
    assert [(r["epoch"], r["step"]) for r in resumed] == [(6, 10), (6, 11)]
    assert resumed[0]["lr"] == train_cfg.lr(10)
    assert all(np.isfinite(r["total"]) for r in resumed)

    iou, pose = cli_test.main(["--config", cfg5, "--data_dir", str(root),
                               "--log_dir", log_dir, "--test_epoch", "5",
                               "--device", "cpu"])
    assert np.isfinite(iou).all() and np.isfinite(pose).all()
    assert len(glob.glob(os.path.join(log_dir, "eval_epoch5", "*.pkl"))) == 2

    # --pretrained_backbone trains from a converted ImageNet-layout trunk
    pth, npz = str(tmp_path / "r18.pth"), str(tmp_path / "r18.npz")
    torch.save(random_resnet_state_dict("resnet18", seed=3), pth)
    convert_torch_resnet.main(["--torch_ckpt", pth, "--out", npz])
    backbone = cli_train.main(["--config", _write_cfg(tmp_path / "bb.yaml",
                                                      1, 2)]
                              + ["--data_dir", str(root / "data"),
                                 "--log_dir", str(tmp_path / "log_bb"),
                                 "--device", "cpu",
                                 "--pretrained_backbone", npz])
    assert [r["step"] for r in backbone.records] == [0, 1]
    assert all(np.isfinite(r["total"]) for r in backbone.records)
    # --devices 2 trains: two CPU ranks under gloo, each on 1 + 1 rows
    dp = cli_train.main(["--config", _write_cfg(tmp_path / "dp.yaml", 1, 2),
                         "--data_dir", str(root / "data"), "--log_dir",
                         str(tmp_path / "log_dp"), "--device", "cpu",
                         "--devices", "2"])
    assert [r["step"] for r in dp.records] == [0, 1] and dp.step == 2
    assert all(np.isfinite(r["total"]) for r in dp.records)
    assert len(dp.digests) == 2 and len(set(dp.digests)) == 1
    # a bf16 config trains under the bf16 policy, its parameters float32
    bf16 = _write_cfg(tmp_path / "bf16.yaml", 1, 2, compute_dtype="bfloat16")
    try:
        trained = cli_train.main(["--config", bf16, "--data_dir",
                                  str(root / "data"), "--log_dir",
                                  str(tmp_path / "log_bf16"), "--device",
                                  "cpu"])
        assert precision.compute_dtype() == torch.bfloat16
    finally:
        precision.set_compute_dtype(torch.float32)
    assert [r["step"] for r in trained.records] == [0, 1]
    assert all(np.isfinite(r["total"]) for r in trained.records)
    assert all(p.dtype == torch.float32 for p in trained.model.parameters())


def test_two_phase_smoke_prints_ok(tmp_path, capsys, quiet_logger):
    from istnet_tpu_torch.cli import two_phase_smoke

    two_phase_smoke.main(["--work_dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "TWO_PHASE_SMOKE OK" in out
    assert "2 result pkls" in out
