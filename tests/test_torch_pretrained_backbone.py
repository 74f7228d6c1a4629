"""ImageNet weights for the port's RGB trunk (``cli/convert_torch_resnet.py``,
``cli/train.py --pretrained_backbone``) against the JAX package's.

A torchvision-layout state dict with seeded random values
(``entry.random_resnet_state_dict``; nothing is downloaded) is saved as a
``.pth``. The port's converter writes the same ``.npz`` trees as JAX's
``build_flax_trees``, key for key and array for array (resnet18 and
resnet50). ``load_pretrained_backbone`` gives the state that JAX's
``load_into_params`` followed by the weight bridge gives, for ``ISTNet``
and ``PoseNetGT``, bit for bit, and refuses a file that does not fit.
``cli/train.py --pretrained_backbone`` starts PoseNetGT from the file and
trains 2 CPU steps.
"""

import logging

import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu_torch.cli import convert_torch_resnet as R
from istnet_tpu_torch.convert import ConversionError, state_dict_from_jax
from istnet_tpu_torch.entry import build_model, random_resnet_state_dict
from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.models.posenet_gt import PoseNetGT
from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet
from test_torch_train_loop import _write_cfg, root  # noqa: F401

torch.set_num_threads(1)

TINY = (32, 16, 8, 8)
ENCODERS = {"ist_net": "rgb_cam_extractor", "posenet_gt": "rgb_extractor"}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``backend -> (.pth, the port's .npz)``."""
    d = tmp_path_factory.mktemp("backbone")
    out = {}
    for seed, backend in enumerate(("resnet18", "resnet50")):
        pth = str(d / f"{backend}.pth")
        torch.save(random_resnet_state_dict(backend, seed), pth)
        out[backend] = pth, R.main(["--torch_ckpt", pth,
                                    "--out", str(d / f"{backend}.npz")])
    return out


def _assert_trees_equal(got, want, path=""):
    assert isinstance(got, dict) and set(got) == set(want), path
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{path}/{k}")
        else:
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=f"{path}/{k}")


@pytest.mark.parametrize("backend", ["resnet18", "resnet50"])
def test_npz_equals_jax_build_flax_trees(files, backend):
    from istnet_tpu.cli import convert_torch_resnet as jax_convert

    pth, npz = files[backend]
    want_p, want_s = jax_convert.build_flax_trees(
        jax_convert.torch_sd_to_numpy(pth))
    got_p, got_s = R.load_npz_trunk(npz)
    _assert_trees_equal(got_p, want_p)
    _assert_trees_equal(got_s, want_s)
    # and the port's own build_flax_trees on the same arrays
    own_p, own_s = R.build_flax_trees(R.torch_sd_to_numpy(pth))
    _assert_trees_equal(own_p, want_p)
    _assert_trees_equal(own_s, want_s)


def _trees(model_name: str, seed: int) -> dict:
    src = (build_model(sa_npoints=TINY, seed=seed, device="cpu")
           if model_name == "ist_net" else PoseNetGT(sa_npoints=TINY))
    return C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()}, model_name)


@pytest.mark.parametrize("model_name", ["ist_net", "posenet_gt"])
def test_load_equals_jax_load_into_params(files, model_name):
    from istnet_tpu.cli.convert_torch_resnet import load_into_params

    _, npz = files["resnet18"]
    encoder = ENCODERS[model_name]
    trees = _trees(model_name, seed=5)
    params, stats = load_into_params(trees["params"], trees["batch_stats"],
                                     npz, encoder_name=encoder)
    want = state_dict_from_jax({"params": params, "batch_stats": stats},
                               model_name)
    model = (ISTNet if model_name == "ist_net" else PoseNetGT)(
        sa_npoints=TINY)
    model.load_state_dict(state_dict_from_jax(trees, model_name), strict=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    written = R.load_pretrained_backbone(model, npz, encoder)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    trunk = f"{encoder}.model.feats."
    assert written and all(k.startswith(trunk) for k in written)
    assert f"{trunk}fc.weight" not in written
    assert not any(torch.equal(got[k], before[k]) for k in written
                   if k.endswith(".weight"))
    assert all(torch.equal(got[k], before[k]) for k in got
               if k not in written)


def test_load_refuses_a_file_that_does_not_fit(files, tmp_path):
    _, npz50 = files["resnet50"]
    model = ISTNet(sa_npoints=TINY)
    with pytest.raises(ConversionError, match="does not fit"):
        R.load_pretrained_backbone(model, npz50)
    # an unused leaf raises, as the bridge does
    trunk_p, trunk_s = R.load_npz_trunk(files["resnet18"][1])
    trunk_p["BasicBlock_0"]["_RConv_7"] = {
        "Conv_0": {"kernel": np.zeros((1, 1, 64, 64), np.float32)}}
    extra = str(tmp_path / "extra.npz")
    np.savez(extra, params=trunk_p, batch_stats=trunk_s)
    with pytest.raises(ConversionError, match="not mapped"):
        R.load_pretrained_backbone(model, extra)
    # the resnet50 file loads into a resnet50 encoder on its own
    encoder = ModifiedResnet("resnet50")
    written = R.load_pretrained_backbone(encoder, npz50, encoder="")
    assert any(".conv3." in k for k in written)
    want = R.torch_sd_to_numpy(files["resnet50"][0])
    got = encoder.state_dict()
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(got["model.feats." + k].numpy(), w)


def test_cli_train_starts_from_the_backbone(files, root, tmp_path,
                                            monkeypatch):
    """PoseNetGT (its encoder ``rgb_extractor``): before step 1 the trunk
    is the file's; 2 steps train to finite losses."""
    from istnet_tpu_torch.cli import train as cli_train
    from istnet_tpu_torch.train.solver import Solver

    pth, npz = files["resnet18"]
    want = R.torch_sd_to_numpy(pth)
    seen = {}
    solve = Solver.solve

    def checked(self):
        sd = self.model.state_dict()
        seen.update({k: sd[f"rgb_extractor.model.feats.{k}"].numpy().copy()
                     for k in want})
        return solve(self)

    monkeypatch.setattr(Solver, "solve", checked)
    cfg = _write_cfg(tmp_path / "pngt.yaml", 1, 2, model_arch="posenet_gt")
    try:
        solver = cli_train.main(["--config", cfg, "--data_dir",
                                 str(root / "data"), "--log_dir",
                                 str(tmp_path / "log"), "--device", "cpu",
                                 "--pretrained_backbone", npz])
    finally:
        logger = logging.getLogger("istnet")
        for h in list(logger.handlers):
            logger.removeHandler(h)
            h.close()
    assert set(seen) == set(want)
    for k, w in want.items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_array_equal(seen[k], w, err_msg=k)
    assert [r["step"] for r in solver.records] == [0, 1]
    assert all(np.isfinite(r["total"]) for r in solver.records)
