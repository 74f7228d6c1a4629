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


def test_train_mode_is_refused(slice_outputs):
    _, _, port, inputs = slice_outputs
    with pytest.raises(NotImplementedError, match="train branch"):
        port.train()(inputs)
    port.eval()


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
        "import chip_smoke\n"
        "m = istnet_tpu_torch.entry.build_model(sa_npoints=(16, 8, 8, 8))\n"
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
