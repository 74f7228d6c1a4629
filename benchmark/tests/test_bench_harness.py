"""The harness end to end on the CPU at tiny shapes: the result line, the
refusals, the manifest's lookup by name, the reference against the port,
and ``correct`` coming out false with the timed path broken underneath."""

import ast
import copy
import io
import json
import math
import shutil
from contextlib import redirect_stdout
from pathlib import Path

import pytest
import torch

from benchmark import control, run
from benchmark.harness import guard, manifest, models
from benchmark.harness.compare import Verdict

TINY = {"img_size": 48, "sample_num": 128, "sa_npoints": [32, 16, 8, 8]}
TRAFFIC = {"frames": {"pool": 2, "trace_items": 1},
           "crops": {"batch": 4, "pool": 2, "trace_items": 1,
                     "check_block": 4},
           "train": {"syn_bs": 3, "real_bs": 1}}


#: a cell taken out of BENCHMARK.json whose files stay in the benchmark
#: (its runs spread too widely to hold a bound; PERF.md, Open questions):
#: driven here as if it were listed, so that its files keep working
PARKED = {"configs": [{"name": "istnet_r18_n2048_frozen",
                       "file": "benchmark/configs/"
                               "istnet_r18_n2048_frozen.json"}],
          "workloads": [{"name": "istnet_r18_n2048_frozen.train_b24",
                         "config": "istnet_r18_n2048_frozen",
                         "traffic": "train_b24", "chips": 1}],
          "reports": "train_samples_per_s"}


def with_parked(spec: dict) -> dict:
    spec = copy.deepcopy(spec)
    spec["configs"] += PARKED["configs"]
    spec["workloads"] += PARKED["workloads"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if PARKED["reports"] in (m["name"], m.get("moves")):
            m["workloads"] += [w["name"] for w in PARKED["workloads"]]
    return spec


@pytest.fixture
def tiny(monkeypatch):
    """Cells at tiny shapes on the CPU: the harness's look for a card
    skipped, the configurations and traffic cut down, the cells' limits
    as committed, the parked cells listed."""
    config, traffic, load = manifest.config, manifest.traffic, manifest.load

    def small_config(spec, name):
        return {**config(spec, name), **TINY}

    def small_traffic(name):
        t = traffic(name)
        return {**t, **TRAFFIC[t["kind"]]}

    monkeypatch.setattr(manifest, "load",
                        lambda path=manifest.MANIFEST: with_parked(load(path)))
    monkeypatch.setattr(manifest, "config", small_config)
    monkeypatch.setattr(manifest, "traffic", small_traffic)
    monkeypatch.setattr(guard, "require_cards", lambda n: torch.device("cpu"))


def _run(cell, seconds=0.3):
    out = io.StringIO()
    with redirect_stdout(out):
        assert run.main(["--workload", cell, "--seed", str(2**31 + 3),
                         "--seconds", str(seconds), "--trace", "0"]) == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


CELLS = [w["name"] for w in with_parked(manifest.load())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct_and_its_line_is_complete(tiny, cell):
    result = _run(cell)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"], result["checks"]
    spec = manifest.load()
    assert set(result["metrics"]) == {
        m["name"] for m in manifest.metrics_of(spec, cell, False)}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    assert result["attempted"] > 0
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in result["metrics"].values())


FAULTS = [(c, f) for c in CELLS for f in (
    ("half_batch", "state_unchanged") if "train" in c else ("answer_swapped",))]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    """The run's own runner, with the program broken underneath it."""
    kind = manifest.kind(manifest.traffic(manifest.cell(
        manifest.load(), cell)["traffic"])["kind"])
    setup = kind.Runner.setup

    def broken_setup(self):
        self.make_traffic()
        if fault != "answer_swapped":
            control.plant(self, fault)
        self.make_program()
        if fault == "answer_swapped":
            control.plant(self, fault)

    from istnet_tpu_torch.train import train_state
    monkeypatch.setattr(train_state, "train_step", train_state.train_step)
    monkeypatch.setattr(kind.Runner, "setup", broken_setup)
    result = _run(cell)
    monkeypatch.setattr(kind.Runner, "setup", setup)
    assert result["correct"] is False, result["checks"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                  "--trace", "0"])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_too_few_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(guard.Refused):
        guard.require_cards(4)


def test_the_import_check_compares_top_level_names_whole():
    names = ["istnet_tpu_torch", "istnet_tpu_torch.ops", "jaxtyping",
             "jax_foo.x", "istnet_tpu", "istnet_tpu.ops.fps", "jaxlib.xla",
             "flax", "numpy"]
    assert guard.forbidden_modules(names) == [
        "flax", "istnet_tpu", "istnet_tpu.ops.fps", "jaxlib.xla"]


def test_a_run_refuses_jax_loaded(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "jax", object())
    with pytest.raises(guard.Refused, match="jax"):
        guard.check_no_jax()


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_the_reference_imports_nothing_of_the_program():
    """The reference imports the standard library, numpy, torch and its own
    modules (relative imports): nothing of the program, of JAX or of the
    harness."""
    for p in (manifest.BENCH / "reference").glob("*.py"):
        bad = _imports(p) - {"__future__", "itertools", "math", "numpy",
                             "torch"}
        assert not bad, (p, bad)


def test_the_harness_imports_no_jax():
    for p in manifest.BENCH.rglob("*.py"):
        bad = _imports(p) & {"jax", "jaxlib", "flax", "istnet_tpu"}
        assert not bad, (p, bad)


def test_the_manifest_finds_new_files_by_name(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(manifest.BENCH, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = manifest.load()
    spec["configs"].append({**spec["configs"][0], "name": "new_config",
                            "file": "benchmark/configs/new_config.json"})
    spec["workloads"].append({"name": "new_config.new_mix",
                              "config": "new_config", "traffic": "new_mix",
                              "chips": 1, "why": "a new cell"})
    spec["per_layer"].append({"name": "new.metric", "unit": "ms",
                              "better": "lower", "source": "device_trace",
                              "layer": "a layer", "moves": "poses_per_s"})
    spec["end_to_end"][0]["workloads"].append("new_config.new_mix")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs" / "new_config.json").write_text(
        json.dumps({"sample_num": 7}))
    (bench / "traffic" / "new_mix.json").write_text(
        json.dumps({"kind": "crops", "batch": 3}))
    (bench / "metrics" / "new.metric.py").write_text(
        "def read(r):\n    return 42.0\n")
    (bench / "limits" / "new_config.new_mix.json").write_text('{"x": 1}')
    monkeypatch.setattr(manifest, "BENCH", bench)
    monkeypatch.setattr(manifest, "ROOT", tmp_path)
    spec = manifest.load(tmp_path / "BENCHMARK.json")
    cell = manifest.cell(spec, "new_config.new_mix")
    assert manifest.config(spec, cell["config"])["sample_num"] == 7
    assert manifest.traffic(cell["traffic"])["batch"] == 3
    assert manifest.limits(cell["name"]) == {"x": 1}
    assert manifest.kind("crops").Runner.__module__ == "benchmark_kind_crops"
    names = [m["name"] for m in manifest.metrics_of(spec, cell["name"], True)]
    assert "new.metric" in names
    assert manifest.reader("new.metric").read({}) == 42.0


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    spec = manifest.load()
    for m in spec["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            reported = {e["name"] for e in manifest.metrics_of(spec, cell,
                                                               False)}
            assert m["moves"] in reported, (m["name"], cell)
        assert callable(manifest.reader(m["name"]).read)


def test_names_that_are_not_names_are_refused():
    with pytest.raises(ValueError):
        manifest.traffic("../configs/x")


def test_the_reference_matches_the_port_at_float32():
    """The port's plain CPU path and the reference at float32, one seed:
    the eval forward, and one train step's loss."""
    from istnet_tpu_torch.nn import precision
    cfg = {**manifest.config(manifest.load(), "istnet_r18_n1024"), **TINY}
    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(1)
    from benchmark.harness import traffic as gen
    batch = gen.train_batch(3, 128, 48, 6, g, cpu)
    try:
        prog = models.program(cfg, 9, cpu, False, "float32")
        ref = models.reference(cfg, 9, cpu, False)
        with torch.no_grad():
            a, b = prog(batch["inputs"]), ref(batch["inputs"])
        for k in ("pred_rotation", "pred_translation", "pred_size", "pred_qo"):
            assert torch.allclose(a[k], b[k], atol=2e-4, rtol=1e-4), k
    finally:
        precision.set_compute_dtype(torch.float32)


def test_verdict():
    v = Verdict({"a": 1.0, "b": 0})
    v.add("a", 0.5)
    v.add("b", 0)
    assert v.correct
    v.add("a", float("nan"))
    assert not v.correct
