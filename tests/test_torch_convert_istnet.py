"""The port's ``cli/convert_torch_istnet.py`` against the JAX package's.

- ``--torch_ckpt``: the ``.npz`` the port writes from a seeded ``.pth``
  (full-width ``ISTNet``, ``PoseNetGT``, and a frozen ``ISTNet`` checkpoint
  without ``world_enhancer.pose_estimator``) equals JAX's ``convert_file``
  leaf for leaf and bit for bit.
- ``--export_npz``: the port's ``.pth`` from JAX trees with nonzero
  SharedMLP dense biases equals JAX's ``export_state_dict`` key for key
  and bit for bit (the biases folded into the BN means).
- ``.pth`` -> ``.npz`` -> ``.pth`` gives the state dict back; the errors
  on a missing or an unmapped key, both ways; ``main``'s flags and its
  default names.
- A converted ``.npz`` gives the same small-width CPU eval forward in JAX
  and in the port, within ``tests/test_torch_model.py``'s 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as J
from istnet_tpu_torch import convert
from istnet_tpu_torch.cli import convert_torch_istnet as P
from istnet_tpu_torch.entry import (build_model, init_weights_, make_inputs,
                                    perturb_eval_stats_)
from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.models.posenet_gt import PoseNetGT

torch.set_num_threads(1)

CASES = {"ist_net": "ist_net", "posenet_gt": "posenet_gt",
         "frozen": "ist_net"}
TINY = (32, 16, 8, 8)
ATOL = 1e-4


def _state(case: str, seed: int) -> dict[str, torch.Tensor]:
    if case == "posenet_gt":
        model = PoseNetGT()
        init_weights_(model, torch.Generator().manual_seed(seed))
        perturb_eval_stats_(model, seed)
    else:
        model = build_model(device="cpu", seed=seed)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    if case == "frozen":
        sd = {k: v for k, v in sd.items()
              if not k.startswith("world_enhancer.pose_estimator.")}
    return sd


@pytest.fixture(scope="module")
def pths(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    out = {}
    for i, case in enumerate(CASES):
        sd = _state(case, seed=i + 3)
        path = str(root / f"{case}.pth")
        torch.save(sd, path)
        out[case] = (path, sd)
    return out


def _assert_trees_equal(got, want, where=""):
    assert set(got) == set(want), (where, sorted(set(got) ^ set(want))[:5])
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_trees_equal(got[k], w, f"{where}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, where + k
        np.testing.assert_array_equal(g, w, err_msg=f"{where}/{k}")


def _set_dense_biases(tree, rng, inside=False):
    """Nonzero SharedMLP dense biases (torch's convs have none)."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if inside and k == "Dense_0":
            v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
        else:
            _set_dense_biases(v, rng, inside or k.startswith("SharedMLP"))


@pytest.mark.parametrize("case", list(CASES))
def test_npz_equals_the_jax_converters(pths, case):
    path, _ = pths[case]
    out = P.main(["--torch_ckpt", path, "--model", CASES[case]])
    assert out == path[:-len(".pth")] + "_tpu.npz"
    got = J.load_npz(out)
    want = J.convert_file(path, CASES[case])
    _assert_trees_equal(got, want)
    world = got["params"].get("world_enhancer", {})
    assert ("pose_estimator" in world) == (case == "ist_net")


@pytest.mark.parametrize("case", list(CASES))
def test_export_equals_the_jax_export(pths, case, tmp_path):
    path, _ = pths[case]
    trees = J.convert_file(path, CASES[case])
    _set_dense_biases(trees["params"], np.random.RandomState(7))
    npz = str(tmp_path / f"{case}_tpu.npz")
    J.save_npz(trees, npz)
    out = P.main(["--export_npz", npz, "--model", CASES[case]])
    assert out == str(tmp_path / f"{case}_tpu_torch.pth")
    got = torch.load(out, weights_only=True)
    want = J.export_state_dict(trees, CASES[case])
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    as_numpy = P.export_state_dict(trees, CASES[case])
    assert set(as_numpy) == set(got)
    for k, v in as_numpy.items():
        np.testing.assert_array_equal(v, got[k].numpy(), err_msg=k)
    # the biases went into the means
    sd = pths[case][1]
    moved = [k for k in got if k.endswith("normlayer.bn.running_mean")
             and not torch.equal(got[k], sd[k])]
    assert moved and all(".layer" in k for k in moved)


@pytest.mark.parametrize("case", list(CASES))
def test_round_trip_gives_the_state_dict_back(pths, case, tmp_path):
    """``.pth`` -> ``.npz`` -> ``.pth``: every key back bit for bit but the
    trunk's dead ``feats.fc``, which comes back as zeros."""
    path, sd = pths[case]
    npz = P.main(["--torch_ckpt", path, "--model", CASES[case],
                  "--out", str(tmp_path / "x.npz")])
    back = torch.load(P.main(["--export_npz", npz, "--model", CASES[case]]),
                      weights_only=True)
    assert set(back) == set(sd)
    for k, v in sd.items():
        if ".feats.fc." in k:
            assert torch.equal(back[k], torch.zeros_like(v)), k
        else:
            assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_a_missing_or_unmapped_torch_key_raises(pths):
    sd = {k: v.numpy() for k, v in pths["ist_net"][1].items()}
    short = {k: v for k, v in sd.items()
             if k != "main_estimator.pose_mlp2.0.weight"}
    with pytest.raises(P.ConversionError, match="missing torch key"):
        P.convert_state_dict(short, "ist_net")
    with pytest.raises(P.ConversionError, match="not mapped"):
        P.convert_state_dict({**sd, "mystery.layer.weight": np.zeros(3)},
                             "ist_net")
    with pytest.raises(P.ConversionError, match="unknown model"):
        P.convert_state_dict(sd, "resnet")


def test_a_missing_or_unmapped_flax_leaf_raises(pths):
    trees = P.convert_state_dict(
        {k: v.numpy() for k, v in pths["posenet_gt"][1].items()},
        "posenet_gt")
    stats = trees["batch_stats"]["pts_extractor"]
    var = stats["PointnetFPModule_0"]["SharedMLP_0"]["BatchNorm_1"].pop("var")
    with pytest.raises(convert.ConversionError, match="missing flax leaf"):
        P.export_state_dict(trees, "posenet_gt")
    stats["PointnetFPModule_0"]["SharedMLP_0"]["BatchNorm_1"]["var"] = var
    P.export_state_dict(trees, "posenet_gt")
    trees["params"]["mystery"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(convert.ConversionError, match="not mapped"):
        P.export_state_dict(trees, "posenet_gt")


def test_main_takes_exactly_one_direction(pths, capsys):
    path, _ = pths["posenet_gt"]
    for argv in ([], ["--torch_ckpt", path, "--export_npz", "x.npz"]):
        with pytest.raises(SystemExit):
            P.main(argv)
        assert "exactly one of" in capsys.readouterr().err


def test_a_converted_npz_runs_the_same_forward_in_both(tmp_path):
    src = build_model(sa_npoints=TINY, seed=5, device="cpu")
    pth = str(tmp_path / "tiny.pth")
    torch.save(src.state_dict(), pth)
    npz = P.main(["--torch_ckpt", pth])
    port = ISTNet(sa_npoints=TINY)
    port.load_state_dict(convert.load_weights(npz), strict=True)
    port.eval()
    inputs = make_inputs(2, 128, 48, seed=11, device="cpu")
    with torch.no_grad():
        got = port(inputs)
        want_port = src(inputs)

    from istnet_tpu.models.ist_net import ISTNet as JaxISTNet

    jm = JaxISTNet(sa_npoints=TINY)
    want = jax.jit(lambda v, i: jm.apply(v, i, train=False))(
        J.load_npz(npz), {k: jnp.asarray(v.numpy()) for k, v in inputs.items()})
    for key in ("pred_rotation", "pred_translation", "pred_size", "pred_qo"):
        torch.testing.assert_close(got[key], want_port[key], rtol=0, atol=0)
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL, err_msg=key)
