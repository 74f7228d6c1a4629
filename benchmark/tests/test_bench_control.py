"""The controls and faults on the card, at each cell's own size: the
reference one precision step below the configuration's in the program's
place, and the program with a planted fault, must each come out not
correct under the cell's committed limits. Run on a card:

    python -m pytest -m gpu benchmark/tests/test_bench_control.py
"""

import pytest

from benchmark import control
from benchmark.harness import manifest
from benchmark.harness.compare import CONTROL, Verdict

SPEC = manifest.load()
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2**31 + 977


def _verdict(cell: str, numbers: dict) -> Verdict:
    v = Verdict(manifest.limits(cell))
    for name, value in numbers.items():
        v.add(name, value)
    return v


def _precision(cell: str) -> str:
    w = manifest.cell(SPEC, cell)
    traffic = manifest.traffic(w["traffic"])
    runner = manifest.kind(traffic["kind"]).Runner(
        manifest.config(SPEC, w["config"]), traffic, "cpu", 0)
    return runner.precision


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(card, cell):
    numbers = control.reading(cell, SEED, 2.0,
                              control=CONTROL[_precision(cell)])
    assert not _verdict(cell, numbers).correct, numbers


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(card, cell):
    numbers = control.reading(cell, SEED, 2.0)
    assert _verdict(cell, numbers).correct, numbers


FAULTS = [(c, f) for c in CELLS for f in (
    ("half_batch", "state_unchanged") if "train" in c else ("answer_swapped",))]


@pytest.mark.gpu
@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_planted_fault_is_not_correct(card, cell, fault):
    numbers = control.reading(cell, SEED, 2.0, fault=fault)
    assert not _verdict(cell, numbers).correct, numbers
