#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from, in one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        --program <seeds> [--control <precision> --control-seeds <seeds>] \
        [--fault <name> --fault-seeds <seeds>]... [--own-pipeline]

For every seed of ``--program`` the cell runs as ``run.py`` runs it (set-up,
a window of ``--seconds``, the program freed, the comparison with the
reference) and prints the compared numbers; their largest is a number's
lower reading. ``--control`` puts the reference, computed at that
precision (``tf32``, ``fp8`` or ``bf16``, ``reference/model.py::Precision``),
in the program's place; each ``--fault`` plants one fault in the program's timed
path. The smallest reading of the control and of each fault that fails
are a number's upper readings. ``--own-pipeline`` feeds a train cell's
reference step from the reference's own pipeline rather than from the
batch the program's pipeline made. Seeds are comma-separated. Each reading is
one JSON line on stdout; a summary ends it. The benchmark's own runs never
run this.

Faults:
- ``answer_swapped`` (serving kinds): the first two instances of every
  frame or batch swap their poses and NOCS points where the program
  produces them;
- ``half_batch`` (train): the step takes the first half of each batch's
  rows, its loss the mean over them;
- ``state_unchanged`` (train): the step returns its loss parts and leaves
  the model and optimizer as they were.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

SWAPPED = ("pred_rotation", "pred_translation", "pred_size", "pred_qo")


def _swap(ep: dict) -> dict:
    out = dict(ep)
    for key in SWAPPED:
        x = ep[key].clone()
        x[[0, 1]] = ep[key][[1, 0]]
        out[key] = x
    return out


def plant(runner, fault: str) -> None:
    """Break the runner's program underneath its timed path."""
    import torch
    if fault == "answer_swapped" and hasattr(runner, "fn"):
        fn = runner.fn

        def swapped(*a, **k):
            ep, n_valid = fn(*a, **k)
            return _swap(ep), n_valid
        swapped.device = fn.device
        runner.fn = swapped
    elif fault == "answer_swapped":
        forward = runner._forward
        runner._forward = lambda i: _swap(forward(i))
    elif fault in ("half_batch", "state_unchanged"):
        from istnet_tpu_torch.train import train_state
        step = train_state.train_step

        def rows(d, n):
            return {k: rows(v, n) if isinstance(v, dict) else v[:n]
                    for k, v in d.items()}

        def half(model, opt, batch, *a, **k):
            first = next(iter(batch.values()))
            b = next(iter(first.values())) if isinstance(first, dict) else first
            return step(model, opt, rows(batch, b.shape[0] // 2), *a, **k)

        def unchanged(model, opt, batch, *a, **k):
            saved = (copy.deepcopy(model.state_dict()),
                     copy.deepcopy(opt.state_dict()))
            parts = step(model, opt, batch, *a, **k)
            with torch.no_grad():
                model.load_state_dict(saved[0])
                opt.load_state_dict(saved[1])
            return parts
        train_state.train_step = half if fault == "half_batch" else unchanged
    else:
        raise ValueError(f"fault {fault!r} does not apply to this cell")


def reading(cell_name: str, seed: int, seconds: float,
            control: str | None = None, fault: str | None = None,
            own_pipeline: bool = False) -> dict:
    import torch
    from benchmark.harness import compare, guard, manifest
    from benchmark.harness.window import Window

    spec = manifest.load()
    cell = manifest.cell(spec, cell_name)
    cfg = manifest.config(spec, cell["config"])
    traffic = manifest.traffic(cell["traffic"])
    device = guard.require_cards(cell["chips"])
    runner = manifest.kind(traffic["kind"]).Runner(cfg, traffic, device, seed)
    if own_pipeline:
        runner.follow = False
    runner.make_traffic()
    if control is None:
        if fault:
            from istnet_tpu_torch.train import train_state
            saved = train_state.train_step
        try:
            if fault in ("half_batch", "state_unchanged"):
                plant(runner, fault)
            runner.make_program()
            if fault == "answer_swapped":
                plant(runner, fault)
            runner.run(Window(seconds))
        finally:
            if fault:
                train_state.train_step = saved
        runner.free()
    verdict = compare.Verdict({}, record_all=True)
    runner.check(verdict, control=control)
    del runner
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {name: v for name, v, _ in verdict.rows}


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--program", default="")
    p.add_argument("--control")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", action="append", default=[])
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--own-pipeline", action="store_true")
    args = p.parse_args(argv)
    runs = [("program", None, None, s) for s in _seeds(args.program)]
    if args.control:
        runs += [(f"control:{args.control}", args.control, None, s)
                 for s in _seeds(args.control_seeds)]
    runs += [(f"fault:{f}", None, f, s) for f in args.fault
             for s in _seeds(args.fault_seeds)]
    by_label: dict = {}
    for label, control, fault, seed in runs:
        numbers = reading(args.workload, seed, args.seconds, control, fault,
                          args.own_pipeline)
        print(json.dumps({"label": label, "seed": seed, **numbers}),
              flush=True)
        by_label.setdefault(label, []).append(numbers)
    summary = {}
    for label, rows in by_label.items():
        pick = max if label == "program" else min
        summary[label] = {k: pick(r[k] for r in rows) for k in rows[0]}
    print(json.dumps({"summary": summary, "workload": args.workload}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
