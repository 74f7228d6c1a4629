"""The port's FSDP against the JAX package's, on the CPU.

Four ranks are four processes of a gloo group (``tests/torch_fsdp_worker.
py``), started once for the module by ``parallel.multihost.spawn``, on a
``(dp, fsdp) = (2, 2)`` mesh; everything runs in float64 at the tiny model
and global batch of ``tests/test_torch_parallel.py`` (B = 4: one row a
rank), dropout off, weights bridged from JAX's trees.

- One FSDP step of the default, frozen and PoseNetGT recipes against JAX's
  ``jit_train_step_fsdp`` over ``make_mesh_2d(2, 2)`` on the CPU under
  x64: loss parts within 2e-6 relative, the gathered state within
  ``_check_state``'s bounds, every rank's gathered state bit-equal; and
  against the port's one-process step on the whole batch to 1e-10.
- The placements: parameters of ``FSDP_MIN_SIZE`` elements or more sharded over
  ``fsdp`` on JAX's axis, their Adam moments too; the BN buffers plain and
  equal on every rank; a rank's parameter and moment bytes half the whole
  (the counterpart of ``tests/test_fsdp.py:100-134``).
- ``make_mesh_2d`` refuses a mesh larger than the world; rank ``r`` sits
  at ``(r // 2, r % 2)``.
- A sharded save at step 1, ``restore_checkpoint_sharded`` and the next
  step bit-equal to the unbroken one, extra meta keys kept; a one-process
  ``restore_checkpoint`` of the same directory, without a group, gives a
  plain model bit-equal to the saved state whose next step matches the
  ranks' to 1e-9.
- ``restore_checkpoint_sharded`` from a plain checkpoint (one process's
  step 0): the gathered model and Adam state bit-equal to the file's, and
  the ranks' next step within 1e-9 of the one-process step from the same
  file.
- The one-process read of a sharded checkpoint rests on two names private
  to torch (``checkpoints._read_sharded``); a test names them.
- A sharded save cut over an earlier checkpoint of its epoch (one process,
  a world-1 group, DCP's save made to raise): the epoch no longer counts,
  and ``latest_epoch`` gives the one before.

The JAX steps run in this process while the ranks run theirs.
"""

import concurrent.futures
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import torch_dp_worker
import torch_fsdp_worker
from istnet_tpu_torch.cli.train import state_digest
from istnet_tpu_torch.convert import state_dict_from_jax
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.parallel import mesh, multihost
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.train.train_state import make_optimizer, train_step
from test_torch_parallel import (
    RECIPES,
    _jax_dp_step,
    _recipe,
    _torch,
    assert_matches_one_process,
)
from test_torch_train_model import _check_state, _no_jax_dropout

torch.set_num_threads(1)

WORLD = 4
MESH = (torch_fsdp_worker.DP, torch_fsdp_worker.FSDP)
MIN_SIZE = mesh.FSDP_MIN_SIZE    # JAX's
JOBS = ["mesh", "default", "ckpt:default", "frozen", "posenet_gt",
        "plain:default"]
PLAIN_META = {"iter": 7}


@pytest.fixture(scope="module")
def fsdp_runs(tmp_path_factory):
    """The 4-rank jobs, all in one spawn (``JOBS``: the mesh's refusal, one
    FSDP step of each recipe, the sharded checkpoint round trip and the
    resume from a plain checkpoint), and meanwhile JAX's FSDP step of each
    recipe. Returns the directory of the jobs' files, each rank's results
    and JAX's ``(metrics, state)`` by recipe."""
    tmp = tmp_path_factory.mktemp("fsdp")
    for name in RECIPES:
        _, state, cfg, batch = _recipe(name)
        arch, freeze, _ = RECIPES[name]
        torch.save({"arch": arch, "freeze": freeze, "state": state,
                    "cfg": cfg, "batch": _torch(batch)}, tmp / f"{name}.pt")
    model, opt = _one_process_step("default", 0)
    checkpoints.save_checkpoint(str(tmp / "plain"), 1, model, opt, 1,
                                extra_meta=PLAIN_META)
    del model, opt
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(multihost.spawn, torch_fsdp_worker.run, WORLD,
                            str(tmp), JOBS, timeout=600)
        with pytest.MonkeyPatch.context() as patch:
            _no_jax_dropout(patch)
            jax_steps = {}
            for name, (arch, freeze, _) in RECIPES.items():
                trees, _, _, batch = _recipe(name)
                jax_steps[name] = _jax_dp_step(trees, arch, freeze, batch,
                                               MESH)
        results = ranks.result()
    yield tmp, results, jax_steps
    shutil.rmtree(tmp, ignore_errors=True)     # ~2.5 GB of float64 states


def _one_process_step(name: str, k: int, ckpt: str | None = None):
    """The recipe's plain model and optimizer (restored from ``ckpt``'s
    epoch 1 if given) after ``train_step`` ``k`` on the whole batch, in
    float64."""
    arch, freeze, _ = RECIPES[name]
    _, state, cfg, batch = _recipe(name)
    precision.set_compute_dtype(torch.float64)
    try:
        model = torch_dp_worker.build(arch, freeze)
        model.load_state_dict(state, strict=True)
        opt = make_optimizer(model, cfg)
        if ckpt is not None:
            checkpoints.restore_checkpoint(ckpt, 1, model, opt)
        train_step(model, opt, _torch(batch), k, torch.Generator(), cfg)
    finally:
        precision.set_compute_dtype(torch.float32)
    return model, opt


def _assert_state_close(got: dict, want: dict, tol: float) -> None:
    """Every float tensor of ``got`` within ``tol`` of ``want``'s largest
    value, every other one equal."""
    assert list(got) == list(want)
    for k, v in got.items():
        if v.is_floating_point():
            assert ((v - want[k]).abs().max()
                    / want[k].abs().max().clamp(min=1e-300)) <= tol, k
        else:
            assert torch.equal(v, want[k]), k


def _rank0(tmp, name: str) -> dict:
    """Rank 0's loss parts, gathered gradients and updated state."""
    return torch.load(tmp / f"{name}_fsdp.pt", weights_only=False)


# ---------------------------------------------------------------------------
# The FSDP step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RECIPES))
def test_four_rank_fsdp_step_matches_jax_fsdp_step(fsdp_runs, name):
    tmp, results, jax_steps = fsdp_runs
    freeze = RECIPES[name][1]
    _, state, cfg, _ = _recipe(name)
    metrics, j_state = jax_steps[name]
    ranks = [res[name] for res in results]
    # every rank's loss parts and gathered state bit-equal
    assert all(r["parts"] == ranks[0]["parts"] for r in ranks)
    assert len({r["digest"] for r in ranks}) == 1
    r0 = _rank0(tmp, name)
    for k, v in r0["parts"].items():
        np.testing.assert_allclose(float(v), metrics["loss" if k == "total"
                                                     else k],
                                   rtol=2e-6, err_msg=k)
    init = {k: v.double() if v.is_floating_point() else v
            for k, v in state.items()}
    _check_state(r0["state"], j_state, init, cfg.lr(0), 1e-3, freeze)


@pytest.mark.parametrize("name", list(RECIPES))
def test_four_rank_fsdp_step_matches_the_one_process_step(fsdp_runs, name):
    """As the 2-rank DDP step (``test_torch_parallel.py``): gradients
    normwise and the state per tensor within 1e-10, loss parts within
    float32 rounding."""
    tmp, _, _ = fsdp_runs
    assert_matches_one_process(_rank0(tmp, name), name)


# ---------------------------------------------------------------------------
# Placements, the mesh
# ---------------------------------------------------------------------------

def _jax_axes(name: str) -> dict:
    """Each parameter's torch dim that JAX's ``_fsdp_leaf_spec`` shards,
    found through the weight bridge: every JAX leaf of ``FSDP_MIN_SIZE`` or
    more
    set to the index along its sharded axis (1 everywhere where JAX
    replicates it), bridged, and read back as the one torch dim that
    varies; None where JAX replicates."""
    from istnet_tpu.parallel.mesh import FSDP_AXIS, _fsdp_leaf_spec

    trees = _recipe(name)[0]

    def mark(leaf):
        spec = _fsdp_leaf_spec(leaf, MESH[1], MIN_SIZE)
        if FSDP_AXIS not in spec:
            return np.ones(leaf.shape)
        axis = list(spec).index(FSDP_AXIS)
        shape = [1] * leaf.ndim
        shape[axis] = leaf.shape[axis]
        return np.broadcast_to(
            np.arange(1, leaf.shape[axis] + 1).reshape(shape), leaf.shape)

    marked = {**trees, "params": jax.tree_util.tree_map(mark,
                                                        trees["params"])}
    bridged = state_dict_from_jax(marked, RECIPES[name][0])
    axes = {}
    for key, t in bridged.items():
        varies = [d for d in range(t.ndim) if t.shape[d] > 1 and not
                  torch.equal(t, t.narrow(d, 0, 1).expand_as(t))]
        assert len(varies) <= 1, key
        axes[key] = varies[0] if varies else None
    return axes


@pytest.mark.parametrize("name", list(RECIPES))
def test_parameters_and_moments_are_sharded_on_jaxs_axis(fsdp_runs, name):
    _, results, _ = fsdp_runs
    ranks = [res[name] for res in results]
    jax_axes = _jax_axes(name)
    frozen = RECIPES[name][1]
    layout = ranks[0]["layout"]
    sharded_on_jax_axis = 0
    plan = layout["plan"]
    assert list(plan["params"]) == list(layout["params"])
    assert list(plan["buffers"]) == list(layout["buffers"])
    assert set(plan["buffers"].values()) == {None}        # replicated
    for key, p in layout["params"].items():
        assert p["dtensor"], key
        # replicated over dp, sharded over fsdp as planned: on JAX's axis
        # where JAX shards the leaf, else on dim 0 (FSDP2 shards every
        # parameter)
        assert p["placements"] == [None, plan["params"][key]], key
        if ".feats.fc." not in key:          # no JAX counterpart
            assert plan["params"][key] == (jax_axes[key] or 0), key
            sharded_on_jax_axis += jax_axes[key] is not None
        # Adam keeps moments for the parameters that had a gradient, placed
        # as they are; the frozen world enhancer has none
        assert p["moments"] == ({"exp_avg": p["placements"],
                                 "exp_avg_sq": p["placements"]}
                                if p["grad"] else {}), key
        assert not (p["grad"] and frozen
                    and key.startswith("world_enhancer.")), key
    assert sharded_on_jax_axis > 0
    # BN buffers: plain tensors, equal on every rank
    assert layout["buffers"] and all(
        list(r["layout"]["buffers"]) == list(layout["buffers"]) and all(
            torch.equal(r["layout"]["buffers"][k], v)
            for k, v in layout["buffers"].items()) for r in ranks)
    # the two ranks of each fsdp group hold the whole state between them,
    # about half each
    whole = layout["whole_bytes"]
    for group in ((0, 1), (2, 3)):
        local = [ranks[r]["layout"]["local_bytes"] for r in group]
        assert sum(local) == whole
        assert all(abs(b / whole - 1 / MESH[1]) < 0.01 for b in local)


def test_make_mesh_2d_refuses_a_mesh_larger_than_the_world(fsdp_runs):
    _, results, _ = fsdp_runs
    for rank, res in enumerate(results):
        assert res["mesh"] == "mesh 4x2 needs 8 devices, have 4"
        assert list(res["coordinate"]) == [rank // MESH[1], rank % MESH[1]]
    with pytest.raises(ValueError, match="mesh 2x2 needs 4 devices, have 1"):
        mesh.make_mesh_2d(2, 2, "cpu")


# ---------------------------------------------------------------------------
# Sharded checkpoints
# ---------------------------------------------------------------------------

def test_sharded_checkpoint_resumes_bit_equal_and_restores_in_one_process(
        fsdp_runs):
    tmp, results, _ = fsdp_runs
    for res in results:
        r = res["ckpt:default"]
        assert r["step"] == 1
        assert r["meta"] == {"epoch": 1, "iter": 1234, "wall_s": 2.5}
        assert r["parts_equal"] and r["state_differs"] == []
    ckpt = str(tmp / "ckpt")
    files = sorted(os.listdir(os.path.join(ckpt, "1")))
    assert files == [".metadata", *(f"__{r}_0.distcp" for r in range(WORLD)),
                     checkpoints.META]
    assert checkpoints.latest_epoch(ckpt) == 1
    # one process, no group: the plain model and optimizer take step 1
    assert not torch.distributed.is_initialized()
    precision.set_compute_dtype(torch.float64)
    try:
        arch, freeze, _ = RECIPES["default"]
        model = torch_dp_worker.build(arch, freeze)
        opt = make_optimizer(model, _recipe("default")[2])
        payload = checkpoints.restore_checkpoint(ckpt, 1, model, opt)
    finally:
        precision.set_compute_dtype(torch.float32)
    assert payload["step"] == 1 and payload["meta"]["iter"] == 1234
    assert state_digest(model) == results[0]["ckpt:default"]["saved_digest"]
    model, _ = _one_process_step("default", payload["step"], ckpt)
    # the one-process step 1 against the 4 ranks' within 1e-9 of each
    # tensor's largest value (measured 4.7e-10: Adam's second step divides
    # by moments that carry the first step's rounding); a wrong moment or
    # step count moves a parameter by ~lr, 1e-4 of its scale
    _assert_state_close(model.state_dict(), torch.load(
        tmp / "ckpt_unbroken.pt"), 1e-9)
    evald = checkpoints.restore_for_eval(ckpt, 1)
    assert set(evald["model"]) == set(model.state_dict())   # DCP's order
    assert evald["step"] == 1 and evald["meta"]["epoch"] == 1


def test_sharded_restore_from_a_plain_checkpoint(fsdp_runs):
    """A one-process run's checkpoint resumed on the (2, 2) mesh: every
    rank takes step 1 and meta, the gathered model and Adam state equal the
    file's in every bit (no moment for a parameter the saved run never
    updated), and the ranks' step 1 is the one-process step 1 from the
    same file within 1e-9 (as the sharded resume above; measured
    3.7e-10)."""
    tmp, results, _ = fsdp_runs
    for rank, res in enumerate(results):
        r = res["plain:default"]
        assert r["step"] == 1 and r["meta"] == {"epoch": 1, **PLAIN_META}
        assert r["differs"] == ([] if rank == 0 else None)
    got = torch.load(tmp / "plain_resumed.pt", weights_only=False)
    model, _ = _one_process_step("default", 1, str(tmp / "plain"))
    _assert_state_close(got["state"], model.state_dict(), 1e-9)


def test_the_one_process_sharded_read_finds_torchs_private_names():
    """``checkpoints._read_sharded`` (``cli/test.py`` and a plain resume of
    an FSDP run) calls DCP's ``_EmptyStateDictLoadPlanner`` and
    ``_load_state_dict(..., no_dist=True)``; a torch without them fails
    here by name."""
    import inspect

    from torch.distributed.checkpoint import default_planner, state_dict_loader

    assert hasattr(default_planner, "_EmptyStateDictLoadPlanner")
    load = getattr(state_dict_loader, "_load_state_dict", None)
    assert load is not None
    assert {"state_dict", "storage_reader", "planner", "no_dist"} <= set(
        inspect.signature(load).parameters)


def test_a_cut_sharded_save_leaves_the_earlier_epoch_whole(tmp_path,
                                                            monkeypatch):
    """One process, a world-1 gloo group: sharded checkpoints of epochs 5
    and 10, then epoch 10 written again with DCP's save failing before its
    first shard. Epoch 10 no longer counts as a checkpoint (its ``meta.pt``
    went before the save), so ``latest_epoch`` falls back to 5, which still
    restores."""
    import torch.distributed.checkpoint as dcp

    multihost.initialize("cpu", store=torch.distributed.HashStore(), rank=0,
                         world_size=1)
    ckpt = str(tmp_path / "ckpt")
    try:
        torch.manual_seed(0)
        model = mesh.shard_state_fsdp(
            mesh.make_mesh_2d(1, 1, "cpu"),
            torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Linear(16, 4)))
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        model(torch.ones(2, 8)).sum().backward()
        opt.step()
        checkpoints.save_checkpoint(ckpt, 5, model, opt, 5)
        checkpoints.save_checkpoint(ckpt, 10, model, opt, 10)
        assert checkpoints.is_sharded_checkpoint(ckpt, 10)
        assert checkpoints.latest_epoch(ckpt) == 10

        def cut(*args, **kwargs):
            raise OSError("the save was cut")
        monkeypatch.setattr(dcp, "save", cut)
        with pytest.raises(OSError, match="the save was cut"):
            checkpoints.save_checkpoint(ckpt, 10, model, opt, 10)
    finally:
        multihost.shutdown()
    assert not torch.distributed.is_initialized()
    assert not checkpoints.has_checkpoint(ckpt, 10)
    assert checkpoints.latest_epoch(ckpt) == 5
    assert checkpoints.restore_for_eval(ckpt, 5)["step"] == 5
