"""Train steps of the program, in a closed loop: step after step on a
pool of batches, each handed to the device as the program's ``Solver``
hands a batch over (``train/solver.py::to_device``: a fresh pinned
buffer, copied without waiting), then ``train_state.train_step`` with the
configuration's recipe and input pipeline (``solver.device_pipeline``).

The configuration's ``train_pipeline`` says what a batch is: ``prepared``
(crops, points, labels: the host loaders' output) or ``device`` (raw
480 x 640 frames that the step's device pipeline completes, crops,
samples, jitters and augments). The step's draws (the pipeline's and the
dropout masks) come from one generator seeded from the run's seed; the
reference draws the same numbers from a generator with the same seed in
the same order.

Set-up builds one step object (model, optimizer, generator) and takes its
first three steps on three different pool batches through the window's
own call; those steps are the check's: each step's loss parts, the first
gradient as Adam holds it after step 1 (its first moment over ``1 -
beta1``) and the change of every parameter and running statistic after
step 3. The window continues the same object from step 4.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.harness import compare, models, traffic as gen
from benchmark.harness.runner import (Runner as Base, module_range, sync,
                                      torch_generator)
from benchmark.harness.trace import span
from benchmark.harness.weights import torch_seed
from benchmark.reference import model as ref_model
from benchmark.reference import train as ref_train
from benchmark.reference import train_pipeline as ref_pipeline

CHECK_STEPS = 3


def _host(batch: dict) -> dict:
    return {k: _host(v) if isinstance(v, dict) else v.cpu().numpy()
            for k, v in batch.items()}


def _clone(batch: dict) -> dict:
    return {k: _clone(v) if isinstance(v, dict) else v.detach().clone()
            for k, v in batch.items()}


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.float()))
            for k, v in tensors.items()}


class Runner(Base):
    #: the check's reference step takes the batch the program's pipeline
    #: made (``reference_steps``); False feeds it from its own pipeline
    follow = True

    @property
    def batch_size(self) -> int:
        return self.traffic["syn_bs"] + self.traffic["real_bs"]

    def recipe(self) -> dict:
        c = self.cfg
        return {"gamma1": c["gamma1"], "gamma2": c["gamma2"],
                "frozen": c["freeze_world_enhancer"],
                "step_size_up": max(1, int(c["max_epoch"]
                                           * c["iters_per_epoch"] / 6))}

    def make_traffic(self) -> None:
        """The pool, in host memory: raw frames for the device pipeline,
        prepared batches otherwise."""
        cfg, b = self.cfg, self.batch_size
        g = torch_generator(self.device, torch_seed(self.seed, 2))
        if cfg["train_pipeline"] == "device":
            def make():
                return gen.raw_train_batch(b, g, self.device)
        else:
            def make():
                return gen.train_batch(b, cfg["sample_num"], cfg["img_size"],
                                       cfg["num_category"], g, self.device)
        self.pool = [_host(make()) for _ in range(self.traffic["pool"])]

    def make_program(self) -> None:
        from istnet_tpu_torch.train import solver
        from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
        cfg = self.cfg
        self.tcfg = TrainConfig(
            gamma1=cfg["gamma1"], gamma2=cfg["gamma2"],
            freeze_world_enhancer=cfg["freeze_world_enhancer"],
            max_epoch=cfg["max_epoch"], iters_per_epoch=cfg["iters_per_epoch"])
        self.program = models.program(cfg, self.seed, self.device, True,
                                      cfg["train_dtype"])
        self.opt = make_optimizer(self.program, self.tcfg)
        self.pipeline = solver.device_pipeline(
            {"train_dataset": {**cfg["train_dataset"],
                               "img_size": cfg["img_size"],
                               "sample_num": cfg["sample_num"]},
             "train_dataloader": cfg["train_dataloader"]}, torch.float32)
        self.gen = torch_generator(self.device, torch_seed(self.seed, 3))
        self.count = 0
        self._first_steps()

    def step(self) -> dict:
        from istnet_tpu_torch.train import solver, train_state
        batch = solver.to_device(self.pool[self.count % len(self.pool)],
                                 torch.device(self.device), torch.float32)
        parts = train_state.train_step(self.program, self.opt, batch,
                                       self.count, self.gen, self.tcfg,
                                       *self.pipeline)
        self.count += 1
        return parts

    def _leaves(self, model):
        params = dict(model.named_parameters())
        bufs = {k: v for k, v in model.named_buffers()
                if k.endswith(("running_mean", "running_var"))}
        return params, bufs

    def _recording(self):
        """The pipeline with its last stage's output kept for the check
        (``self.prepared``): the batch the step's forward takes."""
        pre, aug = self.pipeline
        last = aug or pre
        if last is None:
            return self.pipeline

        def record(batch, g):
            out = last(batch, g)
            self.prepared.append(_clone(out))
            return out
        return (record, None) if aug is None else (pre, record)

    def _first_steps(self) -> None:
        """Steps 1-3 and what the check reads of them."""
        params, bufs = self._leaves(self.program)
        start = {k: v.detach().clone() for k, v in {**params, **bufs}.items()}
        beta1 = self.opt.param_groups[0]["betas"][0]
        name_of = {id(p): k for k, p in params.items()}
        self.losses, self.prepared = [], []
        pipeline, self.pipeline = self.pipeline, self._recording()
        for j in range(CHECK_STEPS):
            parts = self.step()
            self.losses.append({k: float(v) for k, v in parts.items()})
            if j == 0:
                self.grad = {name_of[id(p)]: float(torch.linalg.vector_norm(
                    s["exp_avg"])) / (1.0 - beta1)
                    for p, s in self.opt.state.items() if "exp_avg" in s}
        self.pipeline = pipeline
        self.update = _norms({k: v.detach() - start[k]
                              for k, v in params.items()})
        self.stats = _norms({k: v - start[k] for k, v in bufs.items()})
        del start
        sync(self.device)

    def run(self, window) -> dict:
        self.host_s = []
        window.open()
        while window.more():
            t0 = time.perf_counter()
            self.step()
            self.host_s.append(time.perf_counter() - t0)
            window.add(self.batch_size)
        sync(self.device)
        window.close()
        self.counts = {"attempted": len(self.host_s),
                       "steps": len(self.host_s), "samples": window.units}
        return {"train_samples_per_s": window.rate()}

    def trace(self, window) -> dict:
        n = self.traffic["trace_items"]
        with module_range(self.program, "forward"):
            for _ in range(2):
                self.step()
            sync(self.device)
            with window():
                for _ in range(n):
                    with span("step"):
                        self.step()
                sync(self.device)
        return {"items": n, "units": n * self.batch_size}

    # -- the check ---------------------------------------------------------

    def _pool_batch(self, j: int) -> dict:
        def put(d):
            return {k: put(v) if isinstance(v, dict)
                    else torch.as_tensor(v, device=self.device)
                    for k, v in d.items()}
        return put(self.pool[j])

    def reference_steps(self, precision: str, follow=None) -> dict:
        """The reference's first steps at ``precision``. A raw batch goes
        through the reference's pipeline, its draws from the step's
        generator before the dropout masks; the step then takes that batch,
        or ``follow[j]``, the batch the program's own pipeline made (the
        pipeline's rounding, kernel 11 against the plain fill, moves points
        by some 1e-5 of their size, which flips FPS and radius decisions;
        the pipeline is compared as a stage of its own)."""
        ref_model.Precision(precision).apply_flags()
        model = models.reference(self.cfg, self.seed, self.device, True,
                                 precision)
        step = ref_train.Step(model, self.recipe())
        params, bufs = self._leaves(model)
        start = {k: v.detach().clone() for k, v in {**params, **bufs}.items()}
        g = torch_generator(self.device, torch_seed(self.seed, 3))
        c = self.cfg
        losses, grad, prepared = [], None, []
        for j in range(CHECK_STEPS):
            batch = self._pool_batch(j)
            if c["train_pipeline"] == "device":
                with torch.no_grad():
                    batch = ref_pipeline.prepare(
                        batch, ref_pipeline.draws(self.batch_size,
                                                  c["sample_num"], g),
                        c["img_size"], c["sample_num"])
                prepared.append(batch)
            losses.append(step(batch if follow is None else follow[j], j, g))
            if j == 0:
                grad = {k: float(torch.linalg.vector_norm(step.opt.state[p][0]))
                        / (1.0 - step.opt.b1) for k, p in params.items()
                        if p in step.opt.state and p.grad is not None}
        out = {"losses": losses, "grad": grad, "prepared": prepared,
               "update": _norms({k: v.detach() - start[k]
                                 for k, v in params.items()}),
               "stats": _norms({k: v - start[k] for k, v in bufs.items()})}
        del model, step, start
        return out

    def check(self, verdict, control: str | None = None) -> None:
        if control is not None:
            got = self.reference_steps(control)
        else:
            got = {"losses": self.losses, "grad": self.grad,
                   "update": self.update, "stats": self.stats,
                   "prepared": self.prepared}
        truth = self.reference_steps(
            "float32", got["prepared"] if self.follow and got["prepared"]
            else None)
        if got["prepared"]:
            keys = [(part, k) for part, leaves in truth["prepared"][0].items()
                    for k in leaves]
            verdict.add("pipeline_gap", max(compare.gap(
                [b[part][k] for b in got["prepared"]],
                [b[part][k] for b in truth["prepared"]]) for part, k in keys))
        # leaves the reference moves: a gradient above a thousandth of
        # the median leaf's (a key's bias under softmax, say, moves under
        # Adam by round-off alone)
        g_ref = truth["grad"]
        floor = 1e-3 * float(np.median(list(g_ref.values())))
        moved = [k for k, v in g_ref.items() if v > floor]
        verdict.add("loss_gap", max(compare.rel_gap(p, r) for p, r in
                                    zip(got["losses"], truth["losses"])))
        grads = ({k: got["grad"].get(k, 0.0) for k in moved},
                 {k: g_ref[k] for k in moved})
        updates = ({k: got["update"][k] for k in moved},
                   {k: truth["update"][k] for k in moved})
        verdict.add("grad_gap", compare.leaf_gap(*grads))
        verdict.add("grad_gap_median", compare.median_leaf_gap(*grads))
        verdict.add("update_gap", compare.leaf_gap(*updates))
        verdict.add("update_gap_median", compare.median_leaf_gap(*updates))
        verdict.add("bn_stat_gap", compare.leaf_gap(got["stats"],
                                                    truth["stats"]))

    @property
    def precision(self) -> str:
        return self.cfg["train_dtype"]
