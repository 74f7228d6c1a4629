"""The port's PoseNetGT, its weight bridge and the two-phase transplant
against the JAX package.

The slice: ``PoseNetGT(sa_npoints=(32, 16, 8, 8))`` at B=2, N=128, 48x48
crops on the CPU. Weights: the port's random init with perturbed BN
statistics, converted to flax trees, given nonzero SharedMLP dense biases
there, and carried back by ``state_dict_from_jax(..., "posenet_gt")``.
Dropout is off on both sides. Tolerances are those of the IST-Net train
branch (``tests/test_torch_train_model.py``): per output, max|port - JAX
float64| / max|JAX float64| within 1e-4 (the port's float32 forward) and
1e-6 (its float64 forward); the loss within 1e-6 relative; a float64
trajectory's losses within 2e-6.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from istnet_tpu.cli import convert_torch_istnet as C
from istnet_tpu_torch.convert import ConversionError, state_dict_from_jax
from istnet_tpu_torch.entry import build_model, init_weights_, perturb_eval_stats_
from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.models.posenet_gt import PoseNetGT, supervised_loss
from istnet_tpu_torch.nn import layers, precision
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.train.train_state import (
    TrainConfig,
    make_optimizer,
    train_step,
)

torch.set_num_threads(1)

TINY = (32, 16, 8, 8)
B, N, IMG = 2, 128, 48
BRANCH_F32_TOL = 1e-4
BRANCH_F64_TOL = 1e-6
DETACHED = ("rgb_extractor.", "pts_extractor.")


def _set_dense_biases(tree, rng, inside=False):
    """Nonzero SharedMLP dense biases (the port's convs have none)."""
    for k, v in tree.items():
        if not isinstance(v, dict):
            continue
        if inside and k == "Dense_0":
            v["bias"] = (rng.randn(*v["bias"].shape) * 0.1).astype(np.float32)
        else:
            _set_dense_biases(v, rng, inside or k.startswith("SharedMLP"))


def _posenet_trees(seed):
    src = PoseNetGT(sa_npoints=TINY)
    init_weights_(src, torch.Generator().manual_seed(seed))
    perturb_eval_stats_(src, seed)
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()}, "posenet_gt")
    _set_dense_biases(trees["params"], np.random.RandomState(seed))
    return trees


def _ist_net_trees(seed):
    src = build_model(sa_npoints=TINY, seed=seed, device="cpu")
    trees = C.convert_state_dict(
        {k: v.numpy() for k, v in src.state_dict().items()})
    _set_dense_biases(trees["params"], np.random.RandomState(seed))
    return trees


def _port(trees, dtype=torch.float32):
    model = PoseNetGT(sa_npoints=TINY)
    model.load_state_dict(state_dict_from_jax(trees, "posenet_gt"),
                          strict=True)
    model.to(dtype).train()
    for m in model.modules():
        if isinstance(m, layers.Dropout2d):
            m.eval()
    return model


def _no_jax_dropout(monkeypatch):
    from istnet_tpu.nn import layers as jl
    monkeypatch.setattr(jl.Dropout2d, "__call__", lambda self, x, train: x)


def _batch(k, dtype=np.float32):
    """Step ``k``'s inputs and labels; points spread at std 3 cm so that
    the camera radii find neighbours at 128 points."""
    rng = np.random.RandomState(200 + k)
    inputs = {
        "rgb": rng.randn(B, IMG, IMG, 3).astype(dtype),
        "pts": (rng.randn(B, N, 3) * 0.03).astype(dtype),
        "choose": rng.randint(0, IMG * IMG, (B, N)).astype(np.int32),
        "category_label": np.array([k % 6, (k + 3) % 6], np.int32),
        "qo": ((rng.rand(B, N, 3) - 0.5) * 0.4).astype(dtype),
    }
    labels = {
        "rotation_label": rng.randn(B, 3, 3).astype(dtype),
        "translation_label": (rng.randn(B, 3) * 0.1).astype(dtype),
        "size_label": rng.rand(B, 3).astype(dtype),
        "qo": inputs["qo"],
    }
    return {"inputs": inputs, "labels": labels}


def _torch(batch):
    return {part: {k: torch.from_numpy(v) for k, v in d.items()}
            for part, d in batch.items()}


def _to64(tree):
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64) if a.dtype == np.float32 else a,
        tree)


@contextlib.contextmanager
def _jax_float64():
    from istnet_tpu.nn import precision as jprecision

    jax.config.update("jax_enable_x64", True)
    jprecision.set_compute_dtype(np.float64)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", False)
        jprecision.set_compute_dtype(np.float32)


def test_forward_and_loss_match_jax(monkeypatch):
    """The train-mode outputs and the loss of the port's float32 and
    float64 forwards against ``PoseNetGT.apply(train=True)`` and its
    ``supervised_loss`` under JAX's float64 policy."""
    from istnet_tpu.models.posenet_gt import PoseNetGT as JaxPoseNetGT
    from istnet_tpu.models.posenet_gt import supervised_loss as jax_loss

    _no_jax_dropout(monkeypatch)
    trees = _posenet_trees(seed=41)
    batch = _batch(0)
    jm = JaxPoseNetGT(sa_npoints=TINY)
    with _jax_float64():
        batch64 = _to64(batch)
        want = jax.jit(lambda v, i: jm.apply(v, i, train=True))(
            _to64(trees), batch64["inputs"])
        j_total, _ = jax_loss(want, batch64["labels"])
        want = {k: np.asarray(v, np.float64) for k, v in want.items()}
        j_total = float(j_total)

    for dtype, tol, b in ((torch.float32, BRANCH_F32_TOL, batch),
                          (torch.float64, BRANCH_F64_TOL, batch64)):
        precision.set_compute_dtype(dtype)
        try:
            port = _port(trees, dtype)
            t_batch = _torch(b)
            got = port(t_batch["inputs"])
            total, parts = supervised_loss(got, t_batch["labels"])
        finally:
            precision.set_compute_dtype(torch.float32)
        assert set(got) == set(want)
        for k, w in want.items():
            scale = np.abs(w).max()
            err = np.abs(got[k].detach().double().numpy() - w).max()
            assert err <= tol * scale, f"{dtype} {k}: {err} vs max {scale}"
        np.testing.assert_allclose(total.item(), j_total, rtol=1e-6)
        assert set(parts) == {"total", "pose"}
        assert got["pts_local_w_gt"].requires_grad and total.requires_grad


def test_bridge_loads_strictly_with_the_reference_keys():
    """``state_dict_from_jax(..., "posenet_gt")`` gives exactly the
    reference torch keys (``export_state_dict``'s) and loads strictly; a
    leaf it does not map raises."""
    trees = _posenet_trees(seed=42)
    state = state_dict_from_jax(trees, "posenet_gt")
    assert set(state) == set(C.export_state_dict(trees, "posenet_gt"))
    PoseNetGT(sa_npoints=TINY).load_state_dict(state, strict=True)
    broken = {"params": {**trees["params"], "stray": {"kernel": np.ones(2)}},
              "batch_stats": trees["batch_stats"]}
    with pytest.raises(ConversionError, match="not mapped"):
        state_dict_from_jax(broken, "posenet_gt")
    with pytest.raises(ConversionError, match="unknown model"):
        state_dict_from_jax(trees, "posenet")


def test_load_world_enhancer_matches_the_jax_transplant(tmp_path):
    """PoseNetGT's ``pts_gt_extractor`` into IST-Net's
    ``world_enhancer.extractor``, parameters and BN statistics, from a
    ``.npz`` of JAX trees, against JAX's ``load_world_enhancer`` on the
    same file; the port's checkpoint directory and a reference ``.pth``
    give the same tensors; nothing else of the model changes."""
    from istnet_tpu.train.checkpoints import (
        load_world_enhancer as jax_load_world_enhancer,
    )

    p_trees, i_trees = _posenet_trees(seed=43), _ist_net_trees(seed=44)
    npz = str(tmp_path / "posenet_gt.npz")
    C.save_npz(p_trees, npz)
    params, stats = jax_load_world_enhancer(
        npz, 0, i_trees["params"], i_trees["batch_stats"])
    want = state_dict_from_jax({"params": params, "batch_stats": stats})

    posenet = _port(p_trees)
    pth = str(tmp_path / "posenet_gt.pth")
    torch.save(posenet.state_dict(), pth)
    checkpoints.save_checkpoint(str(tmp_path / "ckpt"), 5, posenet,
                                make_optimizer(posenet, TrainConfig()), 10)
    for source in (npz, pth, str(tmp_path / "ckpt")):
        model = ISTNet(sa_npoints=TINY)
        model.load_state_dict(state_dict_from_jax(i_trees), strict=True)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        moved = checkpoints.load_world_enhancer(source, 5, model)
        after = model.state_dict()
        we = [k for k in after if k.startswith("world_enhancer.extractor.")]
        assert moved == len(we) > 0
        for k, v in after.items():
            if k in we:
                assert torch.equal(v, want[k]), (source, k)
                assert torch.equal(
                    v, posenet.state_dict()["pts_gt_extractor."
                                            + k[len("world_enhancer.extractor."):]])
            else:
                assert torch.equal(v, before[k]), (source, k)


def _jax_trajectory(trees, steps):
    from istnet_tpu.models.posenet_gt import PoseNetGT as JaxPoseNetGT
    from istnet_tpu.models.posenet_gt import supervised_loss as jax_loss
    from istnet_tpu.train.train_state import (
        create_train_state,
        make_optimizer as jax_make_optimizer,
        make_train_step,
    )
    from istnet_tpu.utils.config import Config

    with _jax_float64():
        params, stats = _to64(trees["params"]), _to64(trees["batch_stats"])
        cfg = Config({"optimizer": {"name": "Adam", "weight_decay": 0.0},
                      "max_epoch": 1,
                      "bn": {"bn_momentum": 0.9, "bn_decay": 0.5,
                             "decay_step": 1, "bnm_clip": 0.01}})
        tx, _ = jax_make_optimizer(cfg, 12, params)
        step = jax.jit(make_train_step(JaxPoseNetGT(sa_npoints=TINY),
                                       jax_loss, tx, cfg.bn))
        state = create_train_state(params, stats, tx)
        losses = []
        for k in range(steps):
            state, metrics = step(
                state, jax.tree_util.tree_map(jnp.asarray, _batch(k, np.float64)),
                jax.random.PRNGKey(k))
            losses.append(float(metrics["loss"]))
        return losses, state_dict_from_jax(
            {"params": jax.device_get(state.params),
             "batch_stats": jax.device_get(state.batch_stats)}, "posenet_gt")


def test_a_step_leaves_the_detached_extractors_as_jax_does(monkeypatch):
    """2 float64 steps of the port's ``train_step`` with the PoseNetGT loss
    against JAX's ``make_train_step``: the losses agree (2e-6), and on both
    sides ``rgb_extractor`` and ``pts_extractor``, which feed the pose head
    detached, keep their parameters bit for bit (torch's Adam skips a
    parameter whose ``.grad`` is None, optax's Adam over zero gradients
    moves nothing) while their BNs take the EMA; ``pts_gt_extractor`` and
    ``pose_estimator_aux`` move."""
    _no_jax_dropout(monkeypatch)
    trees = _posenet_trees(seed=45)
    j_losses, j_state = _jax_trajectory(trees, 2)

    cfg = TrainConfig(model_arch="posenet_gt", max_epoch=1, iters_per_epoch=12,
                      decay_step=1)
    precision.set_compute_dtype(torch.float64)
    try:
        model = _port(trees, torch.float64)
        init = {k: v.clone() for k, v in model.state_dict().items()}
        opt = make_optimizer(model, cfg)
        losses = [train_step(model, opt, _torch(_batch(k, np.float64)), k,
                             torch.Generator(), cfg)["total"].item()
                  for k in range(2)]
    finally:
        precision.set_compute_dtype(torch.float32)
    np.testing.assert_allclose(losses, j_losses, rtol=2e-6)

    init_j = state_dict_from_jax(_to64(trees), "posenet_gt")
    for state, start in ((model.state_dict(), init), (j_state, init_j)):
        for k, v in state.items():
            if k.endswith("num_batches_tracked") or ".feats.fc." in k:
                continue
            same = torch.equal(v, start[k])
            if k.startswith(DETACHED) and "running" not in k:
                assert same, k
            elif "running_mean" in k or k.startswith("pts_gt_extractor.SA") \
                    or k.startswith("pose_estimator_aux.pose_mlp"):
                assert not same, k
    for name, p in model.named_parameters():
        assert (p.grad is None) == name.startswith(DETACHED), name
