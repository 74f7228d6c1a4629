"""The port's data-parallel CLIs end to end on the CPU, at the tiny model
(SA npoints 32/16/8/8, N = 128, 48 x 48 crops, a global batch of 2 + 2)
over the port's synthetic trees:

- each rank's loaders (``cli/train.py::build_loaders``) against the JAX
  CLI's per-host loaders: batch sizes ``syn_bs / N`` and ``real_bs / N``,
  seeds ``rd_seed + rank * 7919`` and ``+ 1``, bit for bit;
- ``cli/train.py --device cpu --devices 2`` (two spawned gloo ranks): its
  one checkpoint, written once with the reference keys, then a resume from
  it, both ranks bit-equal after each;
- the same run launched as two processes with torchrun's variables (the
  counterpart of the JAX package's ``test_two_process_cli_train_smoke``,
  DP only): the same losses step by step, a log file a rank;
- ``cli/test.py --device cpu --devices 2`` against ``--devices 1``;
- ``cli/train.py --devices 4`` with ``parallel: {dp: 2, fsdp: 2}`` (the
  counterpart of the JAX package's ``test_cli_train_fsdp``), resumed from
  the two-rank DDP run's epoch-5 checkpoint: JAX's log lines, the sharded
  epoch-10 checkpoint, then ``cli/test.py`` on it in one process;
- ``entry.dryrun_multichip`` over two CPU processes (DP), and over four
  (DP, then FSDP over a (2, 2) mesh).
"""

import contextlib
import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from istnet_tpu.data import dataset as jax_dataset
from istnet_tpu.data import depth_utils as jax_depth_utils
from istnet_tpu.data import loader as jax_loader
from istnet_tpu.data import synthetic as jax_synthetic
from istnet_tpu.utils.config import Config as JaxConfig
from istnet_tpu_torch.data import depth_utils as port_depth_utils
from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.utils import Config
from test_torch_test_loop import _load
from test_torch_train_cli import quiet_logger  # noqa: F401
from test_torch_train_loop import _write_cfg, root  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_batches_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k, w in want.items():
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


def test_each_ranks_loaders_equal_the_jax_clis_per_host_loaders(
        tmp_path, monkeypatch):
    """Rank r of 2: 1 + 1 rows of the config's 2 + 2, its datasets seeded
    ``rd_seed + r * 7919`` and ``+ 1``, as ``istnet_tpu/cli/train.py:175-196``
    builds them, over two epochs (both sides on their OpenCV fill)."""
    from istnet_tpu_torch.cli.train import build_loaders
    from istnet_tpu_torch.data import synthetic

    monkeypatch.setattr(jax_depth_utils, "_NATIVE_OK", False)
    monkeypatch.setattr(port_depth_utils, "_NATIVE_OK", False)
    port, ref = str(tmp_path / "port" / "data"), str(tmp_path / "jax" / "data")
    synthetic.build_train_trees(port, n_scenes=3)
    jax_synthetic.build_train_trees(ref, n_scenes=3)
    cfg_path = _write_cfg(tmp_path / "c.yaml", 1, 2)
    cfg, jcfg = Config.fromfile(cfg_path), JaxConfig.fromfile(cfg_path)
    dl = jcfg.train_dataloader
    for rank in range(2):
        got = build_loaders(cfg, port, 2, rank, 2)
        seed0 = int(jcfg.rd_seed) + rank * 7919
        for name, data_type, bs, seed in (
                ("syn", "syn", int(dl.syn_bs) // 2, seed0),
                ("real", "real_withLabel", int(dl.real_bs) // 2, seed0 + 1)):
            want_ds = jax_dataset.TrainingDataset(
                jcfg.train_dataset, ref, data_type=data_type,
                num_img_per_epoch=2 * bs, use_fill_miss=True,
                use_composed_img=True, per_obj="", seed=seed)
            want = jax_loader.DataLoader(want_ds, bs, shuffle=True,
                                         drop_last=True, num_workers=1)
            assert got[name].batch_size == bs == 1
            for _ in range(2):
                got[name].dataset.reset()
                want_ds.reset()
                g, w = list(got[name]), list(want)
                assert len(g) == len(w) == 2
                for gb, wb in zip(g, w):
                    _assert_batches_equal(gb, wb)


@pytest.fixture(scope="module")
def spawned(root, tmp_path_factory):  # noqa: F811
    """``cli/train.py --devices 2`` for 5 epochs of 1 step (the epoch-5
    checkpoint), then resumed for epoch 6."""
    from istnet_tpu_torch.cli import train as cli_train

    tmp = tmp_path_factory.mktemp("dp_cli")
    log_dir = str(tmp / "log")
    common = ["--data_dir", str(root / "data"), "--log_dir", log_dir,
              "--device", "cpu", "--devices", "2"]
    cfg5 = _write_cfg(tmp / "c5.yaml", 5, 1)
    cfg6 = _write_cfg(tmp / "c6.yaml", 6, 1)
    first = cli_train.main(["--config", cfg5] + common)
    resumed = cli_train.main(["--config", cfg6, "--checkpoint_epoch", "5"]
                             + common)
    return tmp, cfg5, log_dir, first, resumed


def test_two_ranks_train_checkpoint_once_and_resume(
        spawned, quiet_logger):  # noqa: F811
    _, _, log_dir, first, resumed = spawned
    assert [r["step"] for r in first.records] == list(range(5))
    assert all(np.isfinite(r["total"]) for r in first.records)
    assert len(set(first.digests)) == 1 and len(first.digests) == 2
    # one checkpoint (rank 0's), the reference keys without a DDP prefix
    ckpt = os.path.join(log_dir, "ckpt")
    assert glob.glob(os.path.join(ckpt, "*", "*")) == [
        checkpoints.checkpoint_path(ckpt, 5)]
    saved = checkpoints.restore_for_eval(ckpt, 5)
    want_keys = list(ISTNet(sa_npoints=(32, 16, 8, 8)).state_dict())
    assert list(saved["model"]) == want_keys and len(want_keys) == 662
    assert saved["step"] == 5 and saved["meta"]["epoch"] == 5
    # both ranks restored the file and ran epoch 6 to the same bits
    assert [(r["epoch"], r["step"]) for r in resumed.records] == [(6, 5)]
    assert np.isfinite(resumed.records[0]["total"])
    assert len(set(resumed.digests)) == 1
    assert resumed.digests != first.digests
    for rank in range(2):       # each rank's own log file
        assert glob.glob(os.path.join(log_dir, f"train_*_p{rank}.log"))


def test_torchrun_variables_launch_the_same_run(spawned, root):  # noqa: F811
    """Two processes of ``cli/train.py``'s ``main`` with torchrun's
    variables (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) run
    the spawned run: rank 0's loss parts step by step, a log file a rank
    and the epoch-5 checkpoint with the same keys. Step 0's parts agree
    to float32 rounding (1e-5; equal when run alone), which another seed
    on a rank would miss (the one-process run's step 0 is 7e-4 off);
    later ones within 1e-3: two CPU processes under load need not sum
    alike (MKL's products depend on alignment), and Adam turns a gradient
    of rounding noise into a step of +-lr."""
    tmp, cfg5, log_dir, first, _ = spawned
    with socket.socket() as s:          # a free port on this host
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = str(tmp / "torchrun")
    records = str(tmp / "torchrun_records.json")
    main = ("import json, sys; from istnet_tpu_torch.cli import train; "
            "solver = train.main(sys.argv[2:]); "
            "json.dump(solver.records, open(sys.argv[1], 'w')) "
            "if solver.rank == 0 else None")
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": "2",
               "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port),
               # the spawned ranks' threads (cli/train.py)
               "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // 2)),
               "PYTHONPATH": REPO + os.pathsep + os.environ.get(
                   "PYTHONPATH", "")}
        procs.append(subprocess.Popen(
            [sys.executable, "-c", main, records, "--config", cfg5,
             "--data_dir", str(root / "data"), "--log_dir", out_dir,
             "--device", "cpu"], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    with open(records) as f:
        got = json.load(f)
    assert [r["step"] for r in got] == [r["step"] for r in first.records]
    parts = [k for k in first.records[0] if k not in
             ("epoch", "step", "lr") and not k.startswith("T_")]
    for g, w in zip(got, first.records):
        for k in parts:
            np.testing.assert_allclose(g[k], w[k], err_msg=k,
                                       rtol=1e-5 if w["step"] == 0 else 1e-3)
    ckpt = checkpoints.restore_for_eval(os.path.join(out_dir, "ckpt"), 5)
    want = checkpoints.restore_for_eval(os.path.join(log_dir, "ckpt"), 5)
    assert list(ckpt["model"]) == list(want["model"])
    assert ckpt["step"] == want["step"] == 5
    assert len(glob.glob(os.path.join(out_dir, "train_*_p0.log"))) == 1
    assert len(glob.glob(os.path.join(out_dir, "train_*_p1.log"))) == 1


def test_cli_test_over_two_cpu_replicas_equals_one(
        spawned, root, tmp_path, quiet_logger):  # noqa: F811
    """The same pkls: every key and non-float value equal, the poses within
    float32 rounding (1e-5; each replica runs 2 of the 4 rows, and the
    CPU's matrix products sum in an order that depends on the row count)."""
    from istnet_tpu_torch.cli import test as cli_test

    _, cfg5, log_dir, _, _ = spawned
    results = []
    for n in (1, 2):
        out = tmp_path / f"d{n}"
        os.makedirs(out / "ckpt", exist_ok=True)
        os.symlink(os.path.join(log_dir, "ckpt", "5"), out / "ckpt" / "5")
        iou, pose = cli_test.main(["--config", cfg5, "--data_dir", str(root),
                                   "--log_dir", str(out), "--test_epoch", "5",
                                   "--device", "cpu", "--devices", str(n),
                                   "--eval_batch", "4"])
        assert np.isfinite(iou).all() and np.isfinite(pose).all()
        results.append(_load(out / "eval_epoch5"))
    one, two = results
    assert list(one) == list(two) and len(one) == 2
    for name in one:
        assert set(one[name]) == set(two[name])
        for k, v in one[name].items():
            got, want = np.asarray(two[name][k]), np.asarray(v)
            assert got.dtype == want.dtype and got.shape == want.shape, k
            if np.issubdtype(want.dtype, np.floating):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                           err_msg=k)
            else:
                np.testing.assert_array_equal(got, want, err_msg=k)


def test_dryrun_multichip_over_two_cpu_processes():
    from istnet_tpu_torch.entry import dryrun_multichip

    assert np.isfinite(dryrun_multichip(2, device="cpu"))


def test_dryrun_multichip_over_four_cpu_processes_runs_fsdp(capsys):
    from istnet_tpu_torch.entry import dryrun_multichip

    assert np.isfinite(dryrun_multichip(4, device="cpu"))
    out = capsys.readouterr().out
    assert "dryrun_multichip(4): DP OK" in out
    assert "dryrun_multichip(4): FSDP(2x2) OK, loss=" in out


# ---------------------------------------------------------------------------
# FSDP through cli/train.py
# ---------------------------------------------------------------------------

FSDP_EXTRA = {"syn_bs": 4, "real_bs": 4, "per_write": 1,
              "parallel": "{dp: 2, fsdp: 2}"}


@pytest.fixture(scope="module")
def fsdp_spawned(spawned, root, tmp_path_factory):  # noqa: F811
    """``cli/train.py --devices 4`` with ``parallel: {dp: 2, fsdp: 2}`` and
    a global batch of 4 + 4, resumed from the DDP run's epoch-5 checkpoint
    (``spawned``) for epochs 6-10 of 1 step (the sharded epoch-10
    checkpoint)."""
    from istnet_tpu_torch.cli import train as cli_train

    _, _, dp_log_dir, _, _ = spawned
    tmp = tmp_path_factory.mktemp("fsdp_cli")
    log_dir = str(tmp / "log")
    os.makedirs(os.path.join(log_dir, "ckpt"))
    os.symlink(os.path.join(dp_log_dir, "ckpt", "5"),
               os.path.join(log_dir, "ckpt", "5"))
    cfg = _write_cfg(tmp / "f10.yaml", 10, 1, **FSDP_EXTRA)
    with _stderr_to(tmp / "log.txt"):
        run = cli_train.main(["--config", cfg, "--checkpoint_epoch", "5",
                              "--data_dir", str(root / "data"),
                              "--log_dir", log_dir, "--device", "cpu",
                              "--devices", "4"])
    return cfg, log_dir, run, (tmp / "log.txt").read_text()


@contextlib.contextmanager
def _stderr_to(path):
    """File descriptor 2 sent to ``path`` for the block: the spawned ranks
    inherit it, and their loggers print there (the log files keep
    warnings only)."""
    sys.stderr.flush()
    saved = os.dup(2)
    with open(path, "w") as f:
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stderr.flush()
        os.dup2(saved, 2)
        os.close(saved)


def test_cli_train_fsdp_over_four_ranks_checkpoints_and_resumes(
        fsdp_spawned, quiet_logger):  # noqa: F811
    """The counterpart of ``tests/test_cli_train.py::test_cli_train_fsdp``
    (JAX's log lines), on four CPU ranks: the DDP run's plain epoch-5
    checkpoint read into the sharded model and optimizer, epochs 6-10 from
    step 5, every rank's trained model the same, the epoch-10 checkpoint
    sharded (a DCP file a rank)."""
    _, log_dir, run, logs = fsdp_spawned
    assert "parallel: FSDP mesh dp=2 fsdp=2 (4 process(es))" in logs
    assert "resumed from epoch 5 (sharded restore)" in logs
    assert [(r["epoch"], r["step"]) for r in run.records] == [
        (e, e - 1) for e in range(6, 11)]
    assert all(np.isfinite(r["total"]) for r in run.records)
    assert len(run.digests) == 4 and len(set(run.digests)) == 1
    assert "epoch 10 iter 1/1" in logs and "nan" not in logs.lower()
    assert "saved checkpoint at epoch 10" in logs
    ckpt = os.path.join(log_dir, "ckpt")
    assert checkpoints.latest_epoch(ckpt) == 10
    assert sorted(os.listdir(os.path.join(ckpt, "10"))) == [
        ".metadata", *(f"__{r}_0.distcp" for r in range(4)),
        checkpoints.META]


def test_cli_test_in_one_process_on_the_fsdp_checkpoint(
        fsdp_spawned, root, quiet_logger):  # noqa: F811
    """``cli/test.py`` reads the sharded epoch-10 checkpoint whole in one
    process without a group: the reference keys, finite APs."""
    from istnet_tpu_torch.cli import test as cli_test

    cfg, log_dir, _, _ = fsdp_spawned
    saved = checkpoints.restore_for_eval(os.path.join(log_dir, "ckpt"), 10)
    assert set(saved["model"]) == set(ISTNet(sa_npoints=(32, 16, 8, 8))
                                      .state_dict())
    assert saved["step"] == 10 and saved["meta"]["epoch"] == 10
    iou, pose = cli_test.main(["--config", cfg, "--data_dir", str(root),
                               "--log_dir", log_dir, "--test_epoch", "10",
                               "--device", "cpu"])
    assert not torch.distributed.is_initialized()
    assert np.isfinite(iou).all() and np.isfinite(pose).all()
