"""What every traffic kind's runner shares: the device helpers, the
harness's ranges around the program's layers, and the interface that
``run.py`` drives.

A runner (``benchmark/kinds/<kind>.py::Runner``) is built from a
configuration, a traffic mix, a device and a seed, and then:

- ``setup()``: ``make_traffic()``, the pool made from the seed, then
  ``make_program()``: the program, its weights, the warm-up of this
  cell's shapes (and a train step's first steps);
- ``run(window)``: the measured closed loop; returns the end-to-end
  metrics by name;
- ``trace(window)``: a few items inside ``with window():`` (the traced
  window: the ``bench:window`` range, the kernels' least times counted)
  under the profiler, after two items outside it; returns the counts the
  per-layer readers divide by;
- ``free()``: drops the program's state;
- ``check(verdict, control=None)``: the comparison with the reference
  (with ``control``, the reference at that precision takes the program's
  place).
"""

from __future__ import annotations

import contextlib
import functools
import time

import torch

from benchmark.harness.trace import PREFIX


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def module_range(module: torch.nn.Module, name: str):
    """A ``bench:<name>`` range around every forward of ``module``."""
    from torch.profiler import record_function
    stack = []

    def enter(_m, _a):
        rf = record_function(PREFIX + name)
        rf.__enter__()
        stack.append(rf)

    def leave(_m, _a, _o):
        stack.pop().__exit__(None, None, None)

    hooks = [module.register_forward_pre_hook(enter),
             module.register_forward_hook(leave)]
    try:
        yield
    finally:
        for h in hooks:
            h.remove()


@contextlib.contextmanager
def function_range(owner, attr: str, name: str):
    """A ``bench:<name>`` range around every call of ``owner.attr`` (a
    module-level function the program looks up by name)."""
    from torch.profiler import record_function
    fn = getattr(owner, attr)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(PREFIX + name):
            return fn(*args, **kwargs)

    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        setattr(owner, attr, fn)


def torch_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class Runner:
    """Base of the kinds' runners."""

    def __init__(self, cfg: dict, traffic: dict, device, seed: int):
        self.cfg, self.traffic, self.device, self.seed = (cfg, traffic,
                                                          device, seed)
        self.counts: dict = {}

    def readings(self) -> dict:
        """What the per-layer readers take from the untraced window: the
        host ms of the program's call an item, and the compute precision
        (a subclass's ``precision``)."""
        return {"host_ms_per_item": 1e3 * sum(self.host_s) / len(self.host_s),
                "precision": self.precision}

    def setup(self) -> None:
        t0 = time.perf_counter()
        self.make_traffic()
        t1 = time.perf_counter()
        self.make_program()
        self.setup_parts = {"traffic_s": t1 - t0,
                            "program_s": time.perf_counter() - t1}

    def free(self) -> None:
        for attr in ("program", "fn", "opt"):
            if hasattr(self, attr):
                delattr(self, attr)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
