"""The port's whole eval forward against the JAX ``ISTNet``, the weight
bridge, the entry point and import hygiene.

The slice: ``ISTNet(sa_npoints=(32, 16, 8, 8))`` at B=2, N=128, 48x48 crops,
float32 on the CPU (so the port runs its ops' plain versions and JAX its
XLA ops). Weights: the port's random init with perturbed BN statistics and
PReLU slopes, converted to flax trees, given nonzero SharedMLP dense biases
there, and carried back by ``state_dict_from_jax`` into a port model loaded
with ``strict=True``. Outputs agree to 1e-4 absolute (measured ~1e-7: the
frameworks sum convolutions and matmuls in different orders).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu_torch import ops
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.entry import build_model, make_inputs
from istnet_tpu_torch.models.ist_net import ISTNet

torch.set_num_threads(1)

TINY = (32, 16, 8, 8)
ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "tests", "data", "ref_torch_keys.json")) as f:
    REF_KEYS = json.load(f)["ist_net"]


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
def slice_outputs():
    src = build_model(sa_npoints=TINY, seed=5)
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(5))
    port = ISTNet(sa_npoints=TINY)
    port.load_state_dict(state_dict_from_jax(trees), strict=True)
    port.eval()
    inputs = make_inputs(2, 128, 48, seed=11)

    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet

    jm = JaxISTNet(sa_npoints=TINY)
    want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(
        trees, {k: jnp.asarray(v.numpy()) for k, v in inputs.items()})
    ops.reset_launch_counts()
    with torch.no_grad():
        got = port(inputs)
    return got, {k: np.asarray(v) for k, v in want.items()}, port, inputs


@pytest.mark.parametrize("key", ["pred_rotation", "pred_translation",
                                 "pred_size", "pred_qo"])
def test_eval_forward_matches_jax(slice_outputs, key):
    got, want, _, _ = slice_outputs
    assert got[key].shape == want[key].shape
    np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=ATOL)


def test_cpu_forward_launches_no_kernel_and_rotations_are_orthonormal(
        slice_outputs):
    got, _, _, _ = slice_outputs
    assert all(v == 0 for v in ops.launch_counts().values())
    r = got["pred_rotation"]
    torch.testing.assert_close(r.transpose(1, 2) @ r,
                               torch.eye(3).expand(2, 3, 3),
                               rtol=0, atol=1e-5)


def test_dense_eval_head_equals_sparse(slice_outputs):
    got, _, port, inputs = slice_outputs
    port.sparse_eval_head = False
    try:
        with torch.no_grad():
            dense = port(inputs)
    finally:
        port.sparse_eval_head = True
    for k in got:
        torch.testing.assert_close(dense[k], got[k], rtol=0, atol=1e-5)


def test_train_mode_runs_the_train_branch(slice_outputs):
    """Train mode runs the train branch (its parity with JAX is in
    ``tests/test_torch_train_model.py``): the eval outputs plus the world
    features and the auxiliary poses, finite, with a graph to train."""
    _, _, port, inputs = slice_outputs
    train_inputs = {**inputs, "qo": inputs["pts"] * 0.5}
    try:
        out = port.train()(train_inputs, torch.Generator().manual_seed(0))
    finally:
        port.eval()
    assert set(out) == {
        "pred_qo", "pred_rotation", "pred_translation", "pred_size",
        "pts_w_local", "pts_w_local_gt", "pred_rotation_aux_cam",
        "pred_translation_aux_cam", "pred_size_aux_cam",
        "pred_rotation_aux_world", "pred_translation_aux_world",
        "pred_size_aux_world"}
    for k, v in out.items():
        assert torch.isfinite(v).all() and v.requires_grad, k
    assert out["pts_w_local_gt"].shape == (2, 128, 128)


# ---------------------------------------------------------------------------
# Weight bridge
# ---------------------------------------------------------------------------

def test_state_dict_has_the_reference_keys_and_shapes():
    sd = ISTNet().state_dict()
    assert len(sd) == len(REF_KEYS) == 662
    assert {k: list(v.shape) for k, v in sd.items()} == REF_KEYS


def test_reference_layout_state_dict_loads_strictly():
    """A reference-layout checkpoint (all 662 keys, random values) loads
    into the port with strict=True and lands where its key says."""
    rng = np.random.RandomState(0)
    sd = {}
    for k, shape in REF_KEYS.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(0, dtype=torch.long)
        else:
            sd[k] = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    model = ISTNet()
    model.load_state_dict(sd, strict=True)
    got = model.state_dict()
    for k in ("rgb_cam_extractor.model.up_2.conv.1.weight",
              "pts_cam_extractor.FP_modules.3.mlp.layer0.normlayer.bn.running_var",
              "main_estimator.rotation_estimator.4.bias"):
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)


def test_bridge_folds_dense_bias_into_bn_mean():
    src = build_model(sa_npoints=TINY, seed=1)
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    dense = trees["params"]["pts_cam_extractor"]["PointnetFPModule_0"][
        "SharedMLP_0"]["TorchDense_1"]["Dense_0"]
    dense["bias"] = np.full_like(dense["bias"], 0.5)
    sd = state_dict_from_jax(trees)
    key = "pts_cam_extractor.FP_modules.3.mlp.layer1.normlayer.bn.running_mean"
    torch.testing.assert_close(sd[key], src.state_dict()[key] - 0.5)


# ---------------------------------------------------------------------------
# Entry point and imports
# ---------------------------------------------------------------------------

def test_make_inputs_equals_the_jax_entry():
    import __graft_entry__ as g

    want = g._make_inputs(2, 64, 24, train=False, seed=3)
    got = make_inputs(2, 64, 24, seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_importing_the_port_leaves_jax_out():
    code = (
        "import sys\n"
        "import istnet_tpu_torch, istnet_tpu_torch.ops, istnet_tpu_torch.entry\n"
        "import istnet_tpu_torch.convert, istnet_tpu_torch.models.ist_net\n"
        "import istnet_tpu_torch.models.losses, istnet_tpu_torch.train\n"
        "import istnet_tpu_torch.train.schedules\n"
        "import istnet_tpu_torch.train.train_state as ts\n"
        "import istnet_tpu_torch.ops.ball_query, istnet_tpu_torch.ops.three_nn\n"
        "import istnet_tpu_torch.ops.group_scatter\n"
        "import istnet_tpu_torch.ops.interp_scatter\n"
        "import chip_smoke\n"
        "m = istnet_tpu_torch.entry.build_model(sa_npoints=(16, 8, 8, 8))\n"
        "t = istnet_tpu_torch.entry.build_train_model(sa_npoints=(16, 8, 8, 8))\n"
        "ts.make_optimizer(t, ts.TrainConfig())\n"
        "bad = [n for n in ('jax', 'flax', 'istnet_tpu') if n in sys.modules]\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   timeout=120)


def test_chip_smoke_checks_the_kernels_at_the_path_shapes(monkeypatch):
    """The shapes chip_smoke.py holds each kernel to are the ones the
    full-width forward gives it (recorded here on the CPU at B=1)."""
    import chip_smoke
    from istnet_tpu_torch.nn import pointnet2_msg, resnet_psp

    seen = {"fps": [], "ball_query_group": [], "fp_interpolate": [],
            "fold_upsample": []}

    def spy(name, fn, shape):
        def wrapped(*args, **kwargs):
            seen[name].append(shape(*args))
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(pointnet2_msg.ops, "furthest_point_sample", spy(
        "fps", ops.furthest_point_sample, lambda x, k: (x.shape[1], k)))
    monkeypatch.setattr(pointnet2_msg.ops, "ball_query_group", spy(
        "ball_query_group", ops.ball_query_group,
        lambda r, ns, x, c, f: (x.shape[1], c.shape[1],
                                0 if f is None else f.shape[-1])))
    monkeypatch.setattr(pointnet2_msg.ops, "fp_interpolate", spy(
        "fp_interpolate", ops.fp_interpolate,
        lambda u, k, f: (u.shape[1], k.shape[1], f.shape[-1])))
    monkeypatch.setattr(resnet_psp.ops, "fold_upsample_conv", spy(
        "fold_upsample", ops.fold_upsample_conv,
        lambda x, k, b, e: (*x.shape[1:], k.shape[-1])))
    with torch.no_grad():
        build_model()(make_inputs(1))
    assert seen == {"fps": list(chip_smoke.FPS_SHAPES),
                    "ball_query_group": list(chip_smoke.BQG_SHAPES),
                    "fp_interpolate": list(chip_smoke.FP_SHAPES),
                    "fold_upsample": [chip_smoke.FOLD_SHAPE]}


def test_chip_smoke_checks_the_train_kernels_at_the_path_shapes(monkeypatch):
    """The train cases of chip_smoke.py are the calls of the full-width
    train step, one case a call: FPS, grouping and FP interpolation at
    every stage of the camera and the world extractor, with their radii;
    the backward kernels at the groupings and interpolations whose inputs
    carry a gradient (recorded on the CPU at B=1, forward only)."""
    import chip_smoke
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.nn import pointnet2_msg

    seen = {name: [] for name in ("fps", "ball_query_group", "fp_interpolate",
                                  "ball_query", "three_nn")}
    real_fps, real_group, real_fp = (ops.furthest_point_sample,
                                     ops.ball_query_group, ops.fp_interpolate)

    def fps(xyz, npoint):
        seen["fps"].append((xyz.shape[1], npoint))
        return real_fps(xyz, npoint)

    def group(radii, nsamples, xyz, new_xyz, features=None, **kw):
        call = (xyz.shape[1], new_xyz.shape[1],
                0 if features is None else features.shape[-1], tuple(radii),
                tuple(nsamples))
        seen["ball_query_group"].append(call)
        if features is not None and features.requires_grad:
            seen["ball_query"].append(call)
        return real_group(radii, nsamples, xyz, new_xyz, features, **kw)

    def fp(unknown, known, feats):
        call = (unknown.shape[1], known.shape[1], feats.shape[-1])
        seen["fp_interpolate"].append(call)
        if feats.requires_grad:
            seen["three_nn"].append(call)
        return real_fp(unknown, known, feats)

    monkeypatch.setattr(pointnet2_msg.ops, "furthest_point_sample", fps)
    monkeypatch.setattr(pointnet2_msg.ops, "ball_query_group", group)
    monkeypatch.setattr(pointnet2_msg.ops, "fp_interpolate", fp)
    model = build_train_model(seed=0, sa_npoints=chip_smoke.TRAIN_SA_NPOINTS)
    model(make_train_batch(1, chip_smoke.TRAIN_POINTS, chip_smoke.TRAIN_IMG)[
        "inputs"], torch.Generator().manual_seed(0))

    cases = chip_smoke.train_kernel_cases("cpu")
    per_step = chip_smoke.TRAIN_PER_STEP
    assert set(cases) == {k for k, v in per_step.items() if v}
    for name, case_list in cases.items():
        assert sum(k for _, k in case_list) == per_step[name], name
    n_of = {"fps": lambda a: (a[0].shape[1], a[1]),
            "ball_query_group": lambda a: (
                a[2].shape[1], a[3].shape[1],
                0 if a[4] is None else a[4].shape[-1], a[0], a[1]),
            "ball_query": lambda a: a[2:4],
            "group_scatter": lambda a: (a[2], a[0][0].shape[1],
                                        a[1][0].shape[-1] - 3),
            "fp_interpolate": lambda a: (a[0].shape[1], a[1].shape[1],
                                         a[2].shape[-1]),
            "three_nn": lambda a: (a[0].shape[1], a[1].shape[1]),
            "interp_scatter": lambda a: (a[0].shape[1], a[3], a[0].shape[-1])}
    got = {name: [n_of[name](a) for a, _ in case_list]
           for name, case_list in cases.items()}
    assert got["fps"] == seen["fps"]
    assert got["ball_query_group"] == seen["ball_query_group"]
    assert got["fp_interpolate"] == seen["fp_interpolate"]
    assert [(x.shape[1], c.shape[1]) for x, c in got["ball_query"]] == [
        call[:2] for call in seen["ball_query"]]
    assert [a[0] for a, _ in cases["ball_query"]] == [
        call[3] for call in seen["ball_query"]]
    assert got["group_scatter"] == [call[:3] for call in seen["ball_query"]]
    assert got["three_nn"] == [call[:2] for call in seen["three_nn"]]
    assert got["interp_scatter"] == seen["three_nn"]
    assert len(seen["ball_query"]) == 6 and len(seen["three_nn"]) == 8
