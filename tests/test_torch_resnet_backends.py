"""The port's other trunk backends (``nn/resnet_psp.py``: resnet34 and the
Bottleneck resnet50/101/152) against the JAX package's.

resnet34 and resnet50: a JAX ``ModifiedResnet(backend=...)`` initialised at
48 x 48, its BN statistics perturbed, is bridged into the port's
(``convert.state_dict_from_jax(..., "modified_resnet")``, strict) and both
run the same numpy-seeded image at B = 1: the dense and the sparse eval
forward within 1e-4 absolute (float32 convolutions summed in other orders;
the port's float64 dense forward too),
and a train-mode forward at B = 2 (batch statistics, dropout off on both
sides), float64 on both sides. resnet101/152: the trunk's keys and shapes
equal a torchvision-layout skeleton. An unknown backend raises.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu_torch.convert import ConversionError, state_dict_from_jax
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet, ResNetTrunk

torch.set_num_threads(1)

IMG = 48
ATOL = 1e-4
DEPTHS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
          "resnet50": (3, 4, 6, 3), "resnet101": (3, 4, 23, 3),
          "resnet152": (3, 8, 36, 3)}


def _perturb_stats(tree, rng):
    for k, v in tree.items():
        if isinstance(v, dict):
            _perturb_stats(v, rng)
        elif k == "mean":
            tree[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
        elif k == "var":
            tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)


@pytest.fixture(scope="module", params=["resnet34", "resnet50"])
def bridged(request):
    from istnet_tpu.nn.resnet_psp import ModifiedResnet as JaxModifiedResnet

    backend = request.param
    jm = JaxModifiedResnet(backend=backend)
    variables = jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.zeros((1, IMG, IMG, 3)), False)
    trees = jax.tree_util.tree_map(np.array, dict(variables))
    _perturb_stats(trees["batch_stats"], np.random.RandomState(1))
    port = ModifiedResnet(backend)
    port.load_state_dict(state_dict_from_jax(trees, "modified_resnet"),
                         strict=True)
    return backend, jm, trees, port


def test_eval_forward_dense_and_sparse_match_jax(bridged):
    from istnet_tpu.nn.resnet_psp import ModifiedResnet as JaxModifiedResnet

    _, jm, trees, port = bridged
    rng = np.random.RandomState(2)
    rgb = rng.rand(1, IMG, IMG, 3).astype(np.float32)
    choose = rng.randint(0, IMG * IMG, (1, 64)).astype(np.int32)
    choose[0, :4] = [0, IMG - 1, IMG * IMG - 1, IMG + 1]

    @jax.jit
    def both(v, x, c):
        return (jm.apply(v, x, False),
                jm.apply(v, x, c, False,
                         method=JaxModifiedResnet.sparse_points))

    want_dense, want_sparse = both(trees, jnp.asarray(rgb), jnp.asarray(choose))
    port.eval()
    with torch.no_grad():
        dense = port(torch.from_numpy(rgb))
        sparse = port.sparse_points(torch.from_numpy(rgb),
                                    torch.from_numpy(choose))
    assert dense.shape == (1, IMG, IMG, 128) and sparse.shape == (1, 64, 128)
    np.testing.assert_allclose(dense.numpy(), np.asarray(want_dense),
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(sparse.numpy(), np.asarray(want_sparse),
                               rtol=0, atol=ATOL)
    # the float64 policy takes the plain fold at up_2 (no kernel takes
    # float64) and gives the same map
    precision.set_compute_dtype(torch.float64)
    try:
        with torch.no_grad():
            dense64 = copy.deepcopy(port).double()(
                torch.from_numpy(rgb).double())
    finally:
        precision.set_compute_dtype(torch.float32)
    np.testing.assert_allclose(dense64.numpy(), np.asarray(want_dense),
                               rtol=0, atol=ATOL)


def test_train_forward_matches_jax(bridged, monkeypatch):
    """Batch statistics over B = 2 at a 6 x 6 trunk map amplify rounding
    through the trunk's depth (float32 drifts ~1e-4 of the largest value
    from float64 on both sides), so the two frameworks are compared under
    their float64 policies, as the other train-mode parity tests hold
    them: within 1e-6 of the largest value; the port's float32 train
    forward is finite."""
    from istnet_tpu.nn import layers as jl
    from istnet_tpu.nn import precision as jprecision

    monkeypatch.setattr(jl.Dropout2d, "__call__", lambda self, x, train: x)
    _, jm, trees, port = bridged
    rgb = np.random.RandomState(3).rand(2, IMG, IMG, 3)
    jax.config.update("jax_enable_x64", True)
    jprecision.set_compute_dtype(np.float64)
    try:
        want = np.asarray(jax.jit(
            lambda v, x: jm.apply(v, x, True, mutable=["batch_stats"])[0])(
                jax.tree_util.tree_map(lambda a: a.astype(np.float64), trees),
                jnp.asarray(rgb)), np.float64)
    finally:
        jax.config.update("jax_enable_x64", False)
        jprecision.set_compute_dtype(np.float32)
    for dtype in (torch.float32, torch.float64):
        model = copy.deepcopy(port).to(dtype).train()
        for m in model.modules():
            if isinstance(m, layers.Dropout2d):
                m.eval()
        precision.set_compute_dtype(dtype)
        try:
            with torch.no_grad():
                got = model(torch.from_numpy(rgb).to(dtype))
        finally:
            precision.set_compute_dtype(torch.float32)
        assert got.shape == want.shape and torch.isfinite(got).all()
    err = np.abs(got.numpy() - want).max()
    assert err <= 1e-6 * np.abs(want).max(), err


def _torchvision_skeleton(backend: str) -> dict:
    """Key -> shape of torchvision's ``resnet<depth>().state_dict()``."""
    bottleneck = backend in ("resnet50", "resnet101", "resnet152")
    exp = 4 if bottleneck else 1
    sd = {"conv1.weight": (64, 3, 7, 7)}

    def bn(name, c):
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            sd[f"{name}.{leaf}"] = (c,)
        sd[f"{name}.num_batches_tracked"] = ()

    bn("bn1", 64)
    c_in = 64
    for li, (c, nb) in enumerate(zip((64, 128, 256, 512), DEPTHS[backend])):
        for sub in range(nb):
            p = f"layer{li + 1}.{sub}"
            ci = c_in if sub == 0 else c * exp
            convs = ([(c, ci, 1), (c, c, 3), (c * 4, c, 1)] if bottleneck
                     else [(c, ci, 3), (c, c, 3)])
            for k, (o, i, ks) in enumerate(convs):
                sd[f"{p}.conv{k + 1}.weight"] = (o, i, ks, ks)
                bn(f"{p}.bn{k + 1}", o)
            if sub == 0 and (li > 0 or ci != c * exp):
                sd[f"{p}.downsample.0.weight"] = (c * exp, ci, 1, 1)
                bn(f"{p}.downsample.1", c * exp)
        c_in = c * exp
    sd["fc.weight"] = (1000, 512 * exp)
    sd["fc.bias"] = (1000,)
    return sd


@pytest.mark.parametrize("backend", sorted(DEPTHS))
def test_trunk_keys_and_shapes_are_torchvision_layout(backend):
    trunk = ResNetTrunk(backend)
    got = {k: tuple(v.shape) for k, v in trunk.state_dict().items()}
    assert got == _torchvision_skeleton(backend)
    assert trunk.out_channels == got["fc.weight"][1]


def test_unknown_backend_raises():
    with pytest.raises(NotImplementedError, match="resnext9000"):
        ModifiedResnet("resnext9000")
    with pytest.raises(NotImplementedError, match="psp_models"):
        ResNetTrunk("resnet200")


def test_bottleneck_bridge_raises_on_an_unused_leaf(bridged):
    backend, _, trees, _ = bridged
    broken = {"params": dict(trees["params"]),
              "batch_stats": trees["batch_stats"]}
    trunk = dict(broken["params"]["ResNet18Trunk_0"])
    block = "Bottleneck_0" if backend == "resnet50" else "BasicBlock_0"
    trunk[block] = {**trunk[block], "_RConv_9": {"Conv_0": {
        "kernel": np.zeros((1, 1, 64, 64), np.float32)}}}
    broken["params"]["ResNet18Trunk_0"] = trunk
    with pytest.raises(ConversionError, match="not mapped"):
        state_dict_from_jax(broken, "modified_resnet")
