"""``BENCHMARK.json`` and the files it names, found by name.

A cell names a configuration and a traffic mix. The configuration's file
is the manifest's ``configs[].file``; the traffic mix is
``benchmark/traffic/<traffic>.json``, whose ``kind`` names the general
runner ``benchmark/kinds/<kind>.py``; a per-layer metric is read by
``benchmark/metrics/<metric name>.py``; a cell's correctness limits are
``benchmark/limits/<cell name>.json``. Adding any of them is adding a file
and an entry: no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def load(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"({', '.join(w['name'] for w in manifest['workloads'])})")


def config(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return {**read_json(ROOT / c["file"]), "name": name}
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return {**read_json(BENCH / "traffic" / f"{_checked(name)}.json"),
            "name": name}


def limits(cell_name: str) -> dict:
    return read_json(BENCH / "limits" / f"{_checked(cell_name)}.json")


def _module(path: Path, label: str):
    key = "benchmark_" + re.sub(r"\W", "_", label)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"{path} (for {label})")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def kind(name: str):
    """The runner module of a traffic kind."""
    return _module(BENCH / "kinds" / f"{_checked(name)}.py", "kind_" + name)


def reader(metric: str):
    """The reader module of a per-layer metric."""
    return _module(BENCH / "metrics" / f"{_checked(metric)}.py",
                   "metric_" + metric)


def metrics_of(manifest: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` prints: its end-to-end metrics
    with ``--trace 0``; with ``--trace 1`` the per-layer metrics that list
    it, or list no cells and move an end-to-end metric it reports."""
    e2e = [m for m in manifest["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
