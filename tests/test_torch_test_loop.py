"""The port's serving path (raw frame -> poses -> result pkls -> mAP) against
the JAX package, on the CPU at the tiny model (SA npoints 32/16/8/8, 48 x 48
crops, 128 points).

Frames come from the port's synthetic tree writer, weights from
``entry.build_model`` bridged to flax trees (with nonzero SharedMLP dense
biases) and back through ``state_dict_from_jax``, the sampler's uniforms
from JAX's keys, fed to both sides. Tolerance: 1e-4 absolute per output of
the device forward and per ``pred_RTs`` entry, the bound the eval-forward
tests hold (float32 sums in another order). Nothing here needs the JAX
package's C++ core.
"""

import ast
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu.data.dataset import TestDataset as JaxTestDataset
from istnet_tpu.eval import nocs_map as jax_nocs_map
from istnet_tpu.eval import test_loop as jax_loop
from istnet_tpu.models.ist_net import ISTNet as JaxISTNet
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.data import synthetic
from istnet_tpu_torch.data.dataset import REAL_INTRINSICS, TestDataset
from istnet_tpu_torch.entry import build_model, make_frame
from istnet_tpu_torch.eval import nocs_map, test_loop
from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.utils import Config

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
TINY = (32, 16, 8, 8)
IMG, NPTS = 48, 128
ATOL = 1e-4
POSE = ("pred_rotation", "pred_translation", "pred_size")


def _set_dense_biases(tree, rng, inside=False):
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if inside and k == "Dense_0":
            v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
        else:
            _set_dense_biases(v, rng, inside or k.startswith("SharedMLP"))


@pytest.fixture(scope="module")
def models():
    src = build_model(sa_npoints=TINY, seed=3, device="cpu")
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(3))
    port = ISTNet(sa_npoints=TINY)
    port.load_state_dict(state_dict_from_jax(trees), strict=True)
    return port.eval(), JaxISTNet(sa_npoints=TINY), trees


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nocs")
    synthetic.build_test_tree(str(root), n_scenes=3, n_inst=3)
    return str(root)


def _cfg():
    return Config({"img_size": IMG, "sample_num": NPTS})


def _load(save_dir):
    out = {}
    for name in sorted(os.listdir(save_dir)):
        if name.endswith(".pkl"):
            with open(os.path.join(save_dir, name), "rb") as f:
                out[name] = pickle.load(f)
    return out


def test_device_forward_matches_jax(models):
    """A frame of 5 instances (the last with 9 valid pixels) in a bucket of
    8: three padding rows with empty masks run through both forwards."""
    port, jm, trees = models
    fr = make_frame(11, 5, n_tiny=1)
    masks, bboxes, category = test_loop._pad_chunk(
        fr["masks"], fr["bboxes"], fr["category_label"], 8)
    key = jax.random.PRNGKey(5)
    v = np.stack([np.array(jax.random.uniform(kk, (NPTS,)))
                  for kk in jax.random.split(key, 8)])
    jfn = jax_loop.make_device_forward(jm, trees, REAL_INTRINSICS,
                                       img_size=IMG, sample_num=NPTS)
    want, want_nv = jfn(jnp.asarray(fr["rgb_full"]),
                        jnp.asarray(fr["depth_raw"]), jnp.asarray(masks),
                        jnp.asarray(bboxes), jnp.asarray(category), key)
    fn = test_loop.make_device_forward(port, REAL_INTRINSICS, img_size=IMG,
                                       sample_num=NPTS)
    got, nv = fn(fr["rgb_full"], fr["depth_raw"], masks, bboxes, category,
                 v=torch.from_numpy(v))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(want_nv))
    assert list(nv.numpy()[4:]) == [9, 0, 0, 0]
    for name in POSE + ("pred_qo",):
        g = got[name].numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all(), name
        # the rows with valid pixels, the 9-pixel one included; the padding
        # rows index one past the crop in JAX and are dropped by both loops
        np.testing.assert_allclose(g[:5], np.asarray(want[name])[:5],
                                   rtol=0, atol=ATOL, err_msg=name)


def test_build_device_forward_runs_on_the_card_unless_asked():
    """The shared serving entry defaults to the card and refuses where there
    is none; the CPU is an explicit request and equals the loop's own
    ``make_device_forward`` on the same model and uniforms."""
    from istnet_tpu_torch.entry import build_device_forward
    from istnet_tpu_torch.nn import precision

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_device_forward(sa_npoints=TINY, img_size=IMG,
                                 sample_num=NPTS)
    old = precision.compute_dtype()
    try:
        model, fn = build_device_forward(torch.float32, "cpu", 3, TINY, IMG,
                                         NPTS)
        fr = make_frame(12, 3)
        v = torch.rand(3, NPTS, generator=torch.Generator().manual_seed(2))
        args = (fr["rgb_full"], fr["depth_raw"], fr["masks"], fr["bboxes"],
                fr["category_label"])
        got, nv = fn(*args, v=v)
        want, want_nv = test_loop.make_device_forward(
            model, REAL_INTRINSICS, img_size=IMG, sample_num=NPTS)(*args, v=v)
    finally:
        precision.set_compute_dtype(old)
    assert next(model.parameters()).device.type == "cpu"
    assert torch.equal(nv, want_nv) and nv.min().item() > 16
    for name in POSE + ("pred_qo",):
        assert torch.equal(got[name], want[name]), name


def test_test_func_matches_jax_loop(models, tree, tmp_path):
    port, jm, trees = models
    jforward = jax.jit(lambda inputs: jm.apply(trees, inputs, train=False))
    jax_loop.test_func(jforward, JaxTestDataset(_cfg(), tree),
                       str(tmp_path / "jax"), progress=False, max_bucket=4)
    test_loop.test_func(test_loop.make_forward(port),
                        TestDataset(_cfg(), tree), str(tmp_path / "port"),
                        progress=False, max_bucket=4)
    want, got = _load(tmp_path / "jax"), _load(tmp_path / "port")
    assert list(got) == list(want) and len(got) == 3
    for name in want:
        assert set(got[name]) == set(want[name])
        assert got[name]["pred_RTs"].shape == (3, 4, 4)
        for key in want[name]:
            np.testing.assert_allclose(got[name][key], want[name][key],
                                       rtol=0, atol=ATOL, err_msg=key)


def test_test_func_batched_matches_test_func(models, tree, tmp_path):
    port = models[0]
    forward = test_loop.make_forward(port)
    test_loop.test_func(forward, TestDataset(_cfg(), tree),
                        str(tmp_path / "a"), progress=False)
    test_loop.test_func_batched(forward, TestDataset(_cfg(), tree),
                                str(tmp_path / "b"), progress=False,
                                batch_size=4, prefetch_workers=2)
    a, b = _load(tmp_path / "a"), _load(tmp_path / "b")
    assert list(a) == list(b)
    for name in a:
        for key in a[name]:
            np.testing.assert_allclose(b[name][key], a[name][key], rtol=0,
                                       atol=1e-5, err_msg=key)


class _Frames:
    """A raw-frame dataset over ``entry.make_frame``: frames of 3, 0, 5 and
    2 instances, one with a 9-pixel mask, so that buckets pad, a frame is
    empty and an instance is dropped."""

    def __init__(self):
        self.specs = [(21, 3, 0), (22, 0, 0), (23, 5, 1), (24, 2, 0)]
        self.result_pkl_list = [f"results_test_scene_1_{i:04d}.pkl"
                                for i in range(len(self.specs))]

    def __len__(self):
        return len(self.specs)

    def __getitem__(self, i):
        seed, k, n_tiny = self.specs[i]
        fr = make_frame(seed, max(k, 1), n_tiny=n_tiny)
        fr = {key: val[:k] if key in ("masks", "bboxes", "category_label")
              else val for key, val in fr.items()}
        rts = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
        rts[:, 2, 3] = 1.0
        gt = {"gt_class_ids": fr["category_label"] + 1,
              "gt_bboxes": fr["bboxes"], "gt_RTs": rts,
              "gt_scales": np.full((k, 3), 0.1, np.float32),
              "gt_handle_visibility": np.ones(k, np.int64),
              "pred_class_ids": fr["category_label"] + 1,
              "pred_bboxes": fr["bboxes"],
              "pred_scores": np.linspace(0.9, 0.5, k).astype(np.float32)}
        return {"index": i, "empty": k == 0, "gt": gt, **fr}


def test_device_loops_keep_the_same_instances(models, tmp_path):
    port = models[0]
    ds = _Frames()
    fn = test_loop.make_device_forward(port, REAL_INTRINSICS, img_size=IMG,
                                       sample_num=NPTS)
    test_loop.test_func_device(fn, ds, str(tmp_path / "a"), progress=False,
                               max_bucket=4)
    test_loop.test_func_device_batched(
        port, ds, str(tmp_path / "b"), REAL_INTRINSICS, img_size=IMG,
        sample_num=NPTS, batch_size=4, kb=2, lag=2, progress=False)
    a, b = _load(tmp_path / "a"), _load(tmp_path / "b")
    assert list(a) == list(b) and len(a) == 4
    kept = [len(a[name]["pred_class_ids"]) for name in a]
    assert kept == [3, 0, 4, 2]          # the 9-pixel instance is dropped
    for name in a:
        assert set(a[name]) == set(b[name])
        for key in ("pred_class_ids", "pred_bboxes", "pred_scores"):
            np.testing.assert_array_equal(a[name][key], b[name][key])
        assert a[name]["pred_RTs"].shape == b[name]["pred_RTs"].shape
        assert np.isfinite(b[name]["pred_RTs"]).all()
        # the two loops draw different uniforms for a frame (their chunks
        # differ), so the poses agree only as far as the sampling lets them
        if len(a[name]["pred_RTs"]):
            assert np.abs(a[name]["pred_RTs"]
                          - b[name]["pred_RTs"]).max() < 0.5


def test_device_loop_on_a_synthetic_tree(models, tree, tmp_path):
    port = models[0]
    ds = TestDataset(_cfg(), tree, device_preprocess=True)
    fn = test_loop.make_device_forward(port, REAL_INTRINSICS, img_size=IMG,
                                       sample_num=NPTS)
    test_loop.test_func_device(fn, ds, str(tmp_path), progress=False)
    got = _load(tmp_path)
    assert len(got) == 3
    host = TestDataset(_cfg(), tree)[0]
    assert got[sorted(got)[0]]["pred_RTs"].shape == (
        int(host["flag_instance"].sum()), 4, 4)


def test_assemble_pose_bucket_and_pad():
    rng = np.random.RandomState(0)
    r, t, s = rng.randn(3, 3, 3), rng.randn(3, 3), rng.rand(3, 3) + 0.1
    for fn in (test_loop.assemble_pose, jax_loop.assemble_pose):
        rts, scales = fn(r.astype(np.float32), t.astype(np.float32),
                         s.astype(np.float32))
        np.testing.assert_allclose(np.linalg.norm(scales, axis=1), 1.0,
                                   atol=1e-6)
    want = jax_loop.assemble_pose(r, t, s)
    got = test_loop.assemble_pose(r, t, s)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert [test_loop._bucket(n, 8) for n in (1, 2, 3, 5, 8, 9, 100)] == \
        [jax_loop._bucket(n, 8) for n in (1, 2, 3, 5, 8, 9, 100)] == \
        [1, 2, 4, 8, 8, 8, 8]
    padded = test_loop.pad_instances(
        {"pts": np.arange(6.0).reshape(2, 3), "choose": np.arange(2)}, 4)
    np.testing.assert_array_equal(padded["choose"], [0, 1, 0, 0])
    assert padded["pts"].shape == (4, 3)


def test_drain_queue_runs_oldest_first_and_late():
    ran = []
    dq = test_loop._DrainQueue(depth=2)
    for i in range(4):
        dq.push(lambda i=i: ran.append(i))
        assert ran == list(range(max(0, i - 1)))
    dq.flush()
    assert ran == [0, 1, 2, 3]


def test_nocs_map_equals_the_jax_package(models, tree, tmp_path):
    port = models[0]
    test_loop.test_func(test_loop.make_forward(port),
                        TestDataset(_cfg(), tree), str(tmp_path),
                        progress=False)
    got = nocs_map.evaluate(str(tmp_path), plot_figure=False)
    want = jax_nocs_map.evaluate(str(tmp_path), plot_figure=False)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)


def test_evaluate_without_matplotlib_keeps_the_aps(models, tree, tmp_path,
                                                   monkeypatch, capsys):
    """A host without matplotlib (the card's machine has none) gets the
    AP arrays and a note instead of the AP-curve figure."""
    import sys

    test_loop.test_func(test_loop.make_forward(models[0]),
                        TestDataset(_cfg(), tree), str(tmp_path),
                        progress=False)
    want = nocs_map.evaluate(str(tmp_path), plot_figure=False)
    monkeypatch.setitem(sys.modules, "matplotlib", None)   # import raises
    got = nocs_map.evaluate(str(tmp_path), plot_figure=True)
    assert "matplotlib is not installed" in capsys.readouterr().out
    assert not (tmp_path / "visual").exists()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cli_end_to_end_from_a_saved_state_dict(models, tree, tmp_path):
    from istnet_tpu_torch.cli import test as cli

    port = models[0]
    ckpt = tmp_path / "tiny.pth"
    torch.save({"model": {"module." + k: v
                          for k, v in port.state_dict().items()}}, ckpt)
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(
        "num_category: 6\nsa_npoints: [32, 16, 8, 8]\n"
        f"test:\n  img_size: {IMG}\n  sample_num: {NPTS}\n")
    base = ["--config", str(cfg), "--data_dir", tree, "--torch_checkpoint",
            str(ckpt), "--device", "cpu"]
    try:
        iou_a, pose_a = cli.main(base + ["--log_dir", str(tmp_path / "a")])
        iou_b, pose_b = cli.main(base + ["--log_dir", str(tmp_path / "b"),
                                         "--device_preprocess",
                                         "--eval_batch", "4"])
    finally:
        import logging
        for h in list(logging.getLogger("istnet").handlers):
            logging.getLogger("istnet").removeHandler(h)
            h.close()
    for aps in (iou_a, pose_a, iou_b, pose_b):
        assert np.isfinite(aps).all()
    a = _load(tmp_path / "a" / "eval_epoch30")
    b = _load(tmp_path / "b" / "eval_epoch30")
    assert list(a) == list(b) and len(a) == 3
    for name in a:
        np.testing.assert_array_equal(a[name]["pred_class_ids"],
                                      b[name]["pred_class_ids"])
    with pytest.raises(SystemExit, match="queue 1"):
        cli.main(base + ["--devices", "2"])
    with pytest.raises(SystemExit, match="no checkpoint of epoch 30"):
        cli.main(["--config", str(cfg), "--data_dir", tree, "--device", "cpu",
                  "--log_dir", str(tmp_path / "c")])
    assert not (tmp_path / "c").exists()


def test_npz_of_jax_trees_loads_through_convert(models, tmp_path):
    from istnet_tpu_torch import convert

    port, _, trees = models
    C.save_npz(trees, str(tmp_path / "t.npz"))
    sd = convert.load_weights(str(tmp_path / "t.npz"))
    fresh = ISTNet(sa_npoints=TINY)
    fresh.load_state_dict(sd, strict=True)
    for k, v in port.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_bridge_equals_the_jax_exporter(models):
    trees = models[2]
    want = C.export_state_dict(trees)
    got = state_dict_from_jax(trees)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    frozen = {"params": {k: dict(v) if k == "world_enhancer" else v
                         for k, v in trees["params"].items()},
              "batch_stats": trees["batch_stats"]}
    del frozen["params"]["world_enhancer"]["pose_estimator"]
    got = state_dict_from_jax(frozen)
    assert not [k for k in got if k.startswith("world_enhancer.pose_est")]
    assert set(got) == set(C.export_state_dict(frozen))
    broken = {"params": {**trees["params"], "stray": {"kernel": np.ones(2)}},
              "batch_stats": trees["batch_stats"]}
    with pytest.raises(ValueError, match="not mapped"):
        state_dict_from_jax(broken)


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _port_files():
    files = sorted((REPO / "istnet_tpu_torch").rglob("*.py"))
    files += sorted((REPO / "tools").glob("*torch*.py"))
    return files + [REPO / "chip_smoke.py"]


def test_port_sources_import_nothing_of_jax():
    """Every ``import`` statement of the port, its card script and its
    tools, wherever it stands in the file."""
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "istnet_tpu"}
    files = _port_files()
    assert len(files) > 40
    bad = [(str(p.relative_to(REPO)), name) for p in files
           for name in _imports(p) if name.split(".")[0] in banned]
    assert not bad, bad
