"""The port's measuring entry points on the CPU: ``bench_torch.py`` against
``bench.py``'s keys and baseline, its refusal without a card,
``tools/train_bench_torch.py``'s step and recipe against a direct
``train_step`` and ``tools/train_bench.py``'s numbers, the REAL275-scale
tree against ``tools/eval_bench.py``'s, the CPU rehearsals of
``tools/eval_bench_torch.py`` and ``tools/profile_fwd_torch.py``, and the
round timer and owner ranges of ``utils/profiling.py``.

Tiny shapes throughout (B=2, 48x48 crops, SA npoints 32/16/8/8): no number
here is a device time."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
TOOLS = REPO / "tools"
SMALL = {"img": 48, "sa_npoints": (32, 16, 8, 8)}


@pytest.fixture
def tools_path(monkeypatch):
    monkeypatch.syspath_prepend(str(TOOLS))
    monkeypatch.syspath_prepend(str(REPO))


@pytest.fixture
def f32_after():
    from istnet_tpu_torch.nn import precision
    yield
    precision.set_compute_dtype(torch.float32)


def _tree(path: Path):
    return ast.parse(path.read_text(), str(path))


def _bench_py_keys() -> set:
    """The keys ``bench.py`` writes into its record: the dict literal and
    the ``record[...] =`` assignments outside its ``except`` (the port
    does not catch a failed train part)."""
    keys = set()
    main = next(n for n in _tree(REPO / "bench.py").body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    handlers = {id(n) for h in ast.walk(main)
                if isinstance(h, ast.ExceptHandler) for n in ast.walk(h)}
    for node in ast.walk(main):
        if id(node) in handlers:
            continue
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", "") == "record"
                        for t in node.targets):
            keys |= {k.value for k in node.value.keys}
        if isinstance(node, ast.Subscript) \
                and getattr(node.value, "id", "") == "record" \
                and isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
    return keys


def _fake_measurements() -> dict:
    def fwd(b, ms):
        return {"inf_per_s": b * 1e3 / ms, "inf_per_s_min": b * 1e3 / ms / 2,
                "inf_per_s_max": b * 1e3 / ms * 2, "ms": ms,
                "ms_rounds": [ms] * 5, "ms_min": ms / 2, "ms_max": ms * 2,
                "peak_gib": 1.0, "busy_share": 0.5}

    def step(ms):
        return {"train_steps_per_sec": 1e3 / ms, "samples_per_sec": 24e3 / ms,
                "batch": 24, "step_ms": ms}
    return {"forward": {"bf16": {32: fwd(32, 16.0), 128: fwd(128, 20.0)},
                        "f32": {32: fwd(32, 32.0), 128: fwd(128, 120.0)}},
            "train": step(170.0),
            "bare": {k: step(150.0) for k in ("f32_default", "f32_frozen",
                                               "bf16_default", "bf16_frozen")}}


def test_bench_record_has_bench_py_keys_and_baseline(tools_path):
    import bench_torch

    want = _bench_py_keys()
    assert {"metric", "value", "unit", "vs_baseline", "batch", "b32_value",
            "b128_value", "train_steps_per_sec", "train_samples_per_sec",
            "train_batch"} <= want
    ref = next(n.value.value for n in _tree(REPO / "bench.py").body
               if isinstance(n, ast.Assign)
               and getattr(n.targets[0], "id", "") == "REF_ESTIMATE")
    assert bench_torch.REF_ESTIMATE == ref == 250.0
    rec = bench_torch.make_record(_fake_measurements(),
                                  "NVIDIA H100 80GB HBM3, 700.00 W")
    assert want <= set(rec)
    assert rec["metric"] == "object pose inferences/sec/chip"
    assert rec["unit"] == "inferences/sec"
    assert rec["value"] == max(rec["b32_value"], rec["b128_value"]) == 6400.0
    assert rec["batch"] == 128 and rec["b32_value"] == 2000.0
    assert rec["vs_baseline"] == rec["value"] / 250.0
    assert rec["train_batch"] == 24
    assert rec["f32_b32_value"] == 1000.0
    assert rec["device"] == {"name": "NVIDIA H100 80GB HBM3",
                             "power_limit": "700.00 W"}
    assert set(rec["train_bare"]) == {"f32_default", "f32_frozen",
                                      "bf16_default", "bf16_frozen"}
    for policy in ("bf16", "f32"):
        for b in (32, 128):
            r = rec[f"forward_{policy}_b{b}"]
            assert {"ms_rounds", "ms_min", "ms_max", "inf_per_s_min",
                    "inf_per_s_max", "peak_gib", "busy_share"} <= set(r)
    assert len(bench_torch.rates(rec)) == 5 + 4 * 3 + 4
    json.dumps(rec)


def test_bench_without_a_card_exits_nonzero_and_prints_no_json():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py")],
                          capture_output=True, text=True, timeout=120,
                          cwd=REPO, env=env)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
    assert "cuda" in proc.stderr.lower()


def _jax_recipe():
    """``tools/train_bench.py:123-131``: the ``Config({...})`` of its
    ``measure_train_steps`` and the loss weights of its ``supervised_loss``
    call (``(gamma1, gamma2 frozen, gamma2)``)."""
    fn = next(n for n in _tree(TOOLS / "train_bench.py").body
              if isinstance(n, ast.FunctionDef)
              and n.name == "measure_train_steps")
    calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)]
    cfg = next(ast.literal_eval(c.args[0]) for c in calls
               if getattr(c.func, "id", "") == "Config")
    loss = next(c for c in calls
                if getattr(c.func, "id", "") == "supervised_loss")
    g2 = loss.args[3]
    return cfg, (loss.args[2].value, g2.body.value, g2.orelse.value)


def test_train_bench_recipe_is_the_jax_benchs(tools_path):
    import train_bench_torch as tb
    from istnet_tpu_torch.train.train_state import TrainConfig

    cfg, gammas = _jax_recipe()
    assert tb.RECIPE == cfg
    assert (tb.GAMMA1, tb.GAMMA2_FROZEN, tb.GAMMA2) == gammas
    assert tb.recipe(False) == TrainConfig(gamma1=1.0, gamma2=10.0)
    assert tb.recipe(True) == TrainConfig.frozen(gamma1=1.0)


@pytest.mark.parametrize("host_pipeline", [False, True])
def test_measure_train_steps_first_step_is_a_direct_train_step(
        tools_path, f32_after, host_pipeline):
    """``measure_train_steps(device="cpu")`` at B=2, 48x48, SA npoints
    32/16/8/8, 128 points: its first step's loss parts equal, bit for bit,
    a ``train_step`` called directly on the same seeds (model, batch and
    generator), the bench's recipe and pipeline; the policy is float32
    again after, and the result carries the bench's keys."""
    import train_bench_torch as tb
    from istnet_tpu_torch.data.device_augment import make_device_augment
    from istnet_tpu_torch.data.device_preprocess import make_train_preprocess
    from istnet_tpu_torch.entry import build_train_model, make_train_raw_batch
    from istnet_tpu_torch.nn import precision
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)

    res = tb.measure_train_steps(2, host_pipeline, points=128, device="cpu",
                                 rounds=1, iters=1, **SMALL)
    assert precision.compute_dtype() == torch.float32
    assert {"train_steps_per_sec", "step_ms", "samples_per_sec", "batch",
            "pipeline", "points", "freeze_world_enhancer", "dtype",
            "build_s", "backend"} <= set(res)
    assert res["backend"] == "cpu" and res["dtype"] == "bfloat16"
    assert res["pipeline"] == ("host" if host_pipeline else "device")
    assert len(res["step_ms_rounds"]) == 1 and res["step_ms"] > 0

    model = build_train_model("cpu", tb.MODEL_SEED,
                              sa_npoints=SMALL["sa_npoints"],
                              dtype=torch.bfloat16)
    cfg = TrainConfig()
    gen = torch.Generator().manual_seed(tb.STEP_SEED)
    if host_pipeline:
        batch, pre = tb.make_host_batch(2, 128, 48, tb.DATA_SEED, "cpu"), None
    else:
        batch = make_train_raw_batch(2, tb.DATA_SEED, "cpu")
        pre = make_train_preprocess(img_size=48, sample_num=128)
    parts = train_step(model, make_optimizer(model, cfg), batch, 0, gen, cfg,
                       pre, make_device_augment())
    assert res["first_loss_parts"] == {k: float(v) for k, v in parts.items()}


def test_make_host_batch_is_the_jax_benchs(tools_path):
    import train_bench
    import train_bench_torch as tb

    want = train_bench.make_host_batch(3, n=16, img=8, seed=5)
    got = tb.make_host_batch(3, 16, 8, 5, "cpu")
    for part in ("inputs", "labels"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            assert got[part][k].numpy().dtype == v.dtype
            assert (got[part][k].numpy() == v).all(), (part, k)


def _files(root: Path) -> dict:
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.path.relpath(os.readlink(p), root))
        elif p.is_file():
            out[rel] = ("file", p.read_bytes())
    return out


def test_real275_scale_tree_is_the_jax_benchs(tools_path, tmp_path):
    """Three images: the same relative files, bytes and symlink targets as
    ``tools/eval_bench.py::build_real275_scale_tree``."""
    import eval_bench
    from istnet_tpu_torch.data.synthetic import build_real275_scale_tree

    eval_bench.build_real275_scale_tree(str(tmp_path / "jax"), 3)
    build_real275_scale_tree(str(tmp_path / "port"), 3)
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert len([k for k in want if k.endswith(".pkl")]) == 3 + 1
    assert sum(kind == "link" for kind, _ in want.values()) == 2 * 3
    assert got == want


def test_eval_bench_rehearsal_runs_every_mode_through_the_loops(
        tools_path, f32_after, monkeypatch, capsys):
    import eval_bench_torch
    from istnet_tpu_torch.eval import test_loop

    ran = []
    for name in ("test_func_batched", "test_func_device",
                 "test_func_device_batched"):
        fn = getattr(test_loop, name)
        monkeypatch.setattr(test_loop, name,
                            lambda *a, _fn=fn, _n=name, **k:
                            ran.append(_n) or _fn(*a, **k))
    assert eval_bench_torch.main(["--device", "cpu", "--images", "3",
                                  "--mode", "all", "--eval_batch", "4"]) == 0
    assert ran == ["test_func_batched", "test_func_device",
                   "test_func_device_batched"]
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["images"] == 3
    for mode in ("batched", "device", "device_batched"):
        assert out[f"{mode}_images_per_sec"] > 0
        assert out[f"{mode}_total_s"] > 0
    assert out["device"].startswith("cpu")


def test_profile_fwd_rehearsal_attributes_the_forward_by_module(
        tools_path, f32_after, capsys):
    """``tools/profile_fwd_torch.py --device cpu``: every program span of
    the forward has its row, and the rows sum to the printed total of all
    events within 1%."""
    import profile_fwd_torch

    res = profile_fwd_torch.profile_forward(2, "bfloat16", "cpu")
    out = capsys.readouterr().out
    rows = {}
    for line in out.splitlines():
        if line.startswith("[by module] forward "):
            owner, ms = line[len("[by module] forward "):].split(" ms (")[0] \
                .rsplit(None, 1)
            rows[owner.strip()] = float(ms)
    for owner in ("feats", "psp", "up_1", "up_2", "up_3", "bn",
                  "forward.transform", "forward.estimate",
                  *(f"sa{i}" for i in range(1, 5)),
                  *(f"fp{i}" for i in range(1, 5))):
        assert rows.get(owner, 0) > 0, (owner, sorted(rows))
    assert res["total_ms"] > 0
    assert abs(res["attributed_ms"] - res["total_ms"]) <= 0.01 * res[
        "total_ms"]
    assert abs(sum(rows.values()) - res["total_ms"]) <= 0.01 * res[
        "total_ms"] + 1e-3 * len(rows)
    assert "every event" in out


def test_rounds_ms_counts_rounds_and_calls_on_the_cpu():
    from istnet_tpu_torch.utils.profiling import rounds_ms

    calls = []
    t = rounds_ms(lambda: calls.append(1), rounds=3, iters=4, warmup=2,
                  device="cpu")
    assert len(calls) == 2 + 3 * 4
    assert len(t["rounds"]) == 3
    assert t["min"] <= t["median"] <= t["max"]


def test_attribute_names_the_program_spans():
    """``profiling.attribute`` takes the innermost program span around an
    operation as its owner, a span inside ``step.update`` as the update,
    and "other" outside every span; spans leave nothing behind once the
    profiler stops."""
    from torch.profiler import ProfilerActivity, profile

    from istnet_tpu_torch.utils import profiling
    from istnet_tpu_torch.utils.tracing import span

    lin = torch.nn.Linear(4, 4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            with span("outer"):
                y = lin(torch.ones(2, 4))
                with span("inner"):
                    y = y * 2
            with span("step.update"):
                with span("adam"):
                    y = y + 1
            y.sum()
    table = profiling.attribute(prof.events(), use_cpu=True)
    assert ("forward", "outer", "GEMMs") in table
    assert ("forward", "inner", "elementwise") in table
    assert ("update", "adam", "elementwise") in table
    assert ("forward", "other", "reductions") in table
    assert {owner for _, owner, _ in table} == {"outer", "inner", "adam",
                                               "other"}
    assert span("outer").__enter__() is None
    assert profiling.busy_and_span([(0, 2), (1, 3), (5, 6)]) == (4, 6)


def test_attribute_rows_take_the_innermost_owner_and_name_port_kernels():
    """``profiling.attribute_rows`` on ``parse_trace``-shaped rows: the
    innermost program span of a row's scope, "other" outside any; an aten
    op's kind, a kernel launched outside aten ops by its name."""
    from istnet_tpu_torch.utils import profiling

    rows = [
        {"name": "void istnet::fps_kernel<8, 2>(float const*)",
         "dur_us": 10.0, "category": "kernel", "op": "istnet:sa1",
         "scope": "istnet:forward/istnet:forward.points/istnet:sa1"},
        {"name": "void istnet::fps_kernel<8, 2>(float const*)",
         "dur_us": 2.0, "category": "kernel", "op": "istnet:forward.points",
         "scope": "bench:forward/istnet:forward.points"},
        {"name": "elementwise_add", "dur_us": 4.0, "category": "kernel",
         "op": "aten::add", "scope": "istnet:forward.estimate"},
        {"name": "gemm", "dur_us": 1.0, "category": "kernel",
         "op": "aten::mm", "scope": ""},
        {"name": "Memset (Device)", "dur_us": 0.5, "category": "gpu_memset",
         "op": "aten::zero_", "scope": "istnet:forward.estimate"},
    ]
    assert profiling.attribute_rows(rows) == {
        ("forward", "sa1", "kernel fps_kernel"): 10.0,
        ("forward", "forward.points", "kernel fps_kernel"): 2.0,
        ("forward", "forward.estimate", "elementwise"): 4.5,
        ("forward", "other", "GEMMs"): 1.0,
    }
