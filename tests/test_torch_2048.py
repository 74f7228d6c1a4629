"""The port at 2048 points (``config/ist_net_2048pt_dp.yaml``'s
``sample_num``) against the JAX package, on the CPU at small widths.

- The train branch at N=2048 (``sa_npoints=(32, 16, 8, 8)``, B=2, 48x48
  crops, SA 1 sampling 32 of the 2048 points): the port's float32 and
  float64 forwards against JAX's float64 train forward, within the train
  parity tests' ``BRANCH_F32_TOL`` / ``BRANCH_F64_TOL`` of each output's
  largest value (``tests/test_torch_train_model.py``).
- ``TrainingDataset`` samples and ``DataLoader`` batches at ``sample_num:
  2048``, bit-equal to JAX's (both on their OpenCV fill, as
  ``tests/test_torch_train_data.py`` runs them).
- The train sampler (``make_train_preprocess``) and the test side
  (``preprocess_shared_image``) at 2048 against JAX's on JAX's draws,
  within the tolerances of ``tests/test_torch_device_train.py`` and
  ``tests/test_torch_device_preprocess.py``.
- ``cli/train.py`` on a tiny frozen bf16 config at 2048 points for 5
  epochs of one step, then ``cli/test.py`` on its checkpoint at
  ``test.sample_num: 2048`` under bf16: finite losses and APs.
"""

import glob
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_device_train as DT
import test_torch_train_model as TM
from istnet_tpu.data import dataset as jax_dataset
from istnet_tpu.data import depth_utils as jax_depth_utils
from istnet_tpu.data import device_preprocess as jdp
from istnet_tpu.data import loader as jax_loader
from istnet_tpu.utils.config import Config as JaxConfig
from istnet_tpu_torch.data import dataset, loader
from istnet_tpu_torch.data import depth_utils as port_depth_utils
from istnet_tpu_torch.data import device_preprocess as dp
from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
from istnet_tpu_torch.models.ist_net import supervised_loss
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.utils import Config
from test_torch_device_preprocess import _frame, _jax_uniforms
from test_torch_train_data import AUG, trees  # noqa: F401
from test_torch_train_loop import _write_cfg, root  # noqa: F401

torch.set_num_threads(1)

N = 2048


def _batch(k, dtype=np.float32):
    """``test_torch_train_model._batch`` at 2048 points (std 3 cm)."""
    rng = np.random.RandomState(300 + k)
    b, img = TM.B, TM.IMG
    inputs = {
        "rgb": rng.randn(b, img, img, 3).astype(dtype),
        "pts": (rng.randn(b, N, 3) * 0.03).astype(dtype),
        "choose": rng.randint(0, img * img, (b, N)).astype(np.int32),
        "category_label": np.array([k % 6, (k + 3) % 6], np.int32),
        "qo": ((rng.rand(b, N, 3) - 0.5) * 0.4).astype(dtype),
    }
    labels = {
        "rotation_label": rng.randn(b, 3, 3).astype(dtype),
        "translation_label": (rng.randn(b, 3) * 0.1).astype(dtype),
        "size_label": rng.rand(b, 3).astype(dtype),
        "qo": inputs["qo"],
    }
    return {"inputs": inputs, "labels": labels}


def test_train_branch_at_2048_points_matches_jax(monkeypatch):
    """Every train-mode output and the loss of the port's float32 and
    float64 forwards at N=2048 against JAX's float64 train forward (the
    reference the train parity tests use: JAX's float32 forward is
    ill-conditioned at this slice)."""
    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet
    from istnet_tpu.models.ist_net import supervised_loss as jax_loss

    TM._no_jax_dropout(monkeypatch)
    trees = TM._trees(seed=22)
    batch = _batch(0)
    jm = JaxISTNet(sa_npoints=TM.TINY)
    with TM._jax_float64():
        batch64 = TM._to64(batch)
        want = jax.jit(lambda v, i: jm.apply(v, i, train=True))(
            TM._to64(trees), batch64["inputs"])
        j_total = float(jax_loss(want, batch64["labels"], 8.0, 10.0,
                                 False)[0])
        want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    assert want["pred_qo"].shape == (TM.B, N, 3)
    for dtype, tol, b in ((torch.float32, TM.BRANCH_F32_TOL, batch),
                          (torch.float64, TM.BRANCH_F64_TOL, batch64)):
        precision.set_compute_dtype(dtype)
        try:
            port = TM._port(trees, False, dtype)
            t_batch = TM._torch(b)
            got = port(t_batch["inputs"])
            total, _ = supervised_loss(got, t_batch["labels"], 8.0, 10.0,
                                       False)
        finally:
            precision.set_compute_dtype(torch.float32)
        assert set(got) == set(want)
        for k, w in want.items():
            scale = np.abs(w).max()
            err = np.abs(got[k].detach().double().numpy() - w).max()
            assert err <= tol * scale, f"{dtype} {k}: {err} vs max {scale}"
        np.testing.assert_allclose(float(total.detach()), j_total, rtol=1e-6)


def _cfg(cls):
    return cls({"img_size": 48, "sample_num": N, "use_shape_aug": True,
                **AUG})


@pytest.mark.parametrize("data_type", ["syn", "real_withLabel"])
def test_training_samples_at_2048_points_equal_the_jax_packages(
        trees, monkeypatch, data_type):  # noqa: F811
    """Samples of both datasets and the batches of their loaders over one
    epoch, at ``sample_num: 2048``, bit for bit."""
    monkeypatch.setattr(jax_depth_utils, "_NATIVE_OK", False)
    monkeypatch.setattr(port_depth_utils, "_NATIVE_OK", False)
    port, ref = trees
    kw = dict(data_type=data_type, num_img_per_epoch=4, seed=6)
    got_ds = dataset.TrainingDataset(_cfg(Config), port, **kw)
    want_ds = jax_dataset.TrainingDataset(_cfg(JaxConfig), ref, **kw)
    got_ds.reset()
    want_ds.reset()
    for i in range(2):
        got, want = got_ds[i], want_ds[i]
        assert set(got) == set(want) and got["pts"].shape == (N, 3)
        for k, w in want.items():
            g, w = np.asarray(got[k]), np.asarray(w)
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
    got_ld = loader.DataLoader(got_ds, 2, num_workers=2)
    want_ld = jax_loader.DataLoader(want_ds, 2, num_workers=2)
    got_ds.reset()
    want_ds.reset()
    batches = list(zip(got_ld, want_ld))
    assert len(batches) == 2
    for got, want in batches:
        assert set(got) == set(want) and got["pts"].shape == (2, N, 3)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]),
                                          np.asarray(want[k]), err_msg=k)


def test_device_train_sampler_at_2048_points_matches_jax():
    """``make_train_preprocess(48, 2048)`` on raw frames against JAX's on
    JAX's draws: ``choose`` equal, points 1e-6 m, ``qo`` 1e-5, ColorJitter
    2e-3 of a level."""
    raw = DT._train_frames(5, b=2)
    key = jax.random.PRNGKey(12)
    want = jdp.make_train_preprocess(48, N)(
        {k: jnp.asarray(v) for k, v in raw.items()}, key)
    got = dp.make_train_preprocess(48, N)(
        {k: torch.from_numpy(v) for k, v in raw.items()},
        DT.jax_preprocess_draws(key, 2, N))
    gi = {k: v.numpy() for k, v in got["inputs"].items()}
    wi = {k: np.asarray(v) for k, v in want["inputs"].items()}
    assert gi["pts"].shape == wi["pts"].shape == (2, N, 3)
    np.testing.assert_array_equal(gi["choose"], wi["choose"])
    np.testing.assert_allclose(gi["pts"], wi["pts"], rtol=0,
                               atol=DT.PTS_ATOL)
    np.testing.assert_allclose(gi["qo"], wi["qo"], rtol=0, atol=DT.QO_ATOL)
    to_255 = lambda x: (x * DT.IMAGENET_STD + DT.IMAGENET_MEAN) * 255  # noqa: E731
    np.testing.assert_allclose(to_255(gi["rgb"]), to_255(wi["rgb"]), rtol=0,
                               atol=DT.CJ_ATOL)


def test_test_side_sampler_at_2048_points_matches_jax():
    """``preprocess_shared_image`` at ``sample_num`` 2048 (the test side of
    ``cli/test.py --device_preprocess``) against JAX's on JAX's uniforms;
    instances with fewer valid pixels than 2048 repeat theirs as JAX's
    do (the last instance has a 3 x 3 mask)."""
    fr, depth = _frame(4, 5, n_tiny=1)
    key = jax.random.PRNGKey(7)
    v = _jax_uniforms(key, 5, N)
    intr = np.asarray(REAL_INTRINSICS, np.float32)
    args = (fr["rgb_full"], depth, fr["masks"], fr["bboxes"], intr)
    want = jdp.preprocess_shared_image_tpu(*map(jnp.asarray, args), key,
                                           img_size=48, sample_num=N)
    got = dp.preprocess_shared_image(*map(torch.from_numpy, args),
                                     img_size=48, sample_num=N,
                                     v=torch.from_numpy(v))
    got = {k: t.numpy() for k, t in got.items()}
    want = {k: np.asarray(a) for k, a in want.items()}
    np.testing.assert_array_equal(got["n_valid"], want["n_valid"])
    assert (want["n_valid"] < N).any() and (want["n_valid"] > N).any()
    np.testing.assert_array_equal(got["choose"], want["choose"])
    np.testing.assert_allclose(got["pts"], want["pts"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["rgb"], want["rgb"], rtol=0, atol=2e-5)


def test_cli_trains_bf16_at_2048_points_and_tests_its_checkpoint(
        root, tmp_path):  # noqa: F811
    """``cli/train.py`` on a frozen bf16 config at 2048 points (5 epochs
    of one step of B = 2 + 2; checkpoint at epoch 5) and ``cli/test.py``
    on that checkpoint at ``test.sample_num: 2048`` under bf16."""
    from istnet_tpu_torch.cli import test as cli_test
    from istnet_tpu_torch.cli import train as cli_train

    cfg = _write_cfg(tmp_path / "c.yaml", 5, 1, compute_dtype="bfloat16",
                     freeze_world_enhancer="True")
    text = open(cfg).read().replace("sample_num: 128", f"sample_num: {N}")
    open(cfg, "w").write(text.replace("gamma2: 10}", "gamma2: 100}"))
    log_dir = str(tmp_path / "log")
    try:
        solver = cli_train.main(["--config", cfg, "--data_dir",
                                 str(root / "data"), "--log_dir", log_dir,
                                 "--device", "cpu"])
        assert precision.compute_dtype() == torch.bfloat16
        assert solver.model.freeze_world_enhancer
        assert all(p.dtype == torch.float32
                   for p in solver.model.parameters())
        iou, pose = cli_test.main(["--config", cfg, "--data_dir",
                                   str(root), "--log_dir", log_dir,
                                   "--test_epoch", "5", "--device", "cpu"])
        assert precision.compute_dtype() == torch.bfloat16
    finally:
        precision.set_compute_dtype(torch.float32)
        logger = logging.getLogger("istnet")
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert [r["step"] for r in solver.records] == list(range(5))
    assert all(np.isfinite(r["total"]) for r in solver.records)
    assert np.isfinite(iou).all() and np.isfinite(pose).all()
    assert len(glob.glob(os.path.join(log_dir, "eval_epoch5", "*.pkl"))) == 2


def test_chip_smoke_checks_the_bf16_2048_train_kernels_at_the_path_shapes(
        monkeypatch):
    """``chip_smoke.train_kernel_cases(points=2048, bf16=True,
    frozen=True)`` are the calls of the full-width frozen bf16 step at 2048
    points, one case a call, in its dtypes: FPS, grouping (bf16 out, bf16
    features) and FP interpolation (bf16 features) in both extractors; the
    backward cases on the path only where the inputs carry a gradient (the
    camera extractor: the frozen world extractor runs without a graph).
    Recorded on the CPU at B=1, forward only."""
    import chip_smoke
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.nn import pointnet2_msg

    seen = {name: [] for name in ("fps", "ball_query_group", "fp_interpolate",
                                  "ball_query", "three_nn")}
    ops = pointnet2_msg.ops
    real_fps, real_group, real_fp = (ops.furthest_point_sample,
                                     ops.ball_query_group, ops.fp_interpolate)

    def fps(xyz, npoint):
        seen["fps"].append((xyz.shape[1], npoint))
        return real_fps(xyz, npoint)

    def group(radii, nsamples, xyz, new_xyz, features=None, out_dtype=None):
        call = (xyz.shape[1], new_xyz.shape[1],
                0 if features is None else features.shape[-1], tuple(radii),
                None if features is None else features.dtype, out_dtype)
        seen["ball_query_group"].append(call)
        if features is not None and features.requires_grad:
            seen["ball_query"].append(call[:4])
        return real_group(radii, nsamples, xyz, new_xyz, features,
                          out_dtype=out_dtype)

    def fp(unknown, known, feats):
        call = (unknown.shape[1], known.shape[1], feats.shape[-1],
                feats.dtype)
        seen["fp_interpolate"].append(call)
        if feats.requires_grad:
            seen["three_nn"].append(call[:3])
        return real_fp(unknown, known, feats)

    monkeypatch.setattr(ops, "furthest_point_sample", fps)
    monkeypatch.setattr(ops, "ball_query_group", group)
    monkeypatch.setattr(ops, "fp_interpolate", fp)
    try:
        model = build_train_model("cpu", seed=0, freeze_world_enhancer=True,
                                  sa_npoints=chip_smoke.TRAIN_SA_NPOINTS,
                                  dtype=torch.bfloat16)
        model(make_train_batch(1, N, chip_smoke.TRAIN_IMG, device="cpu")[
            "inputs"], torch.Generator().manual_seed(0))
        cases = chip_smoke.train_kernel_cases("cpu", points=N, bf16=True,
                                              frozen=True)
    finally:
        precision.set_compute_dtype(torch.float32)
    bf16 = torch.bfloat16
    assert [(a[0].shape[1], a[1]) for a, _ in cases["fps"]] == seen["fps"]
    assert seen["fps"][0] == (N, 512) and seen["fps"][4] == (N, 512)
    assert [(a[2].shape[1], a[3].shape[1],
             0 if a[4] is None else a[4].shape[-1], a[0],
             None if a[4] is None else a[4].dtype, a[5])
            for a, _ in cases["ball_query_group"]] == \
        seen["ball_query_group"]
    assert all(call[5] == bf16 for call in seen["ball_query_group"])
    assert [(a[0].shape[1], a[1].shape[1], a[2].shape[-1], a[2].dtype)
            for a, _ in cases["fp_interpolate"]] == seen["fp_interpolate"]
    assert all(call[3] == bf16 for call in seen["fp_interpolate"])
    on_path = {name: [(a, k) for a, k in case_list if k]
               for name, case_list in cases.items()}
    assert [(a[2].shape[1], a[3].shape[1], a[0])
            for a, _ in on_path["ball_query"]] == [
        (c[0], c[1], c[3]) for c in seen["ball_query"]]
    assert [(a[0].shape[1], a[1].shape[1]) for a, _ in on_path["three_nn"]] \
        == [c[:2] for c in seen["three_nn"]]
    for name, case_list in cases.items():
        assert sum(k for _, k in case_list) == \
            chip_smoke.FROZEN_PER_STEP[name], name
    assert all(g.dtype == bf16 for (_, grads, _), _ in cases["group_scatter"]
               for g in grads)
    assert all(a[0].dtype == bf16 for a, _ in cases["interp_scatter"])
