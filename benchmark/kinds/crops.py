"""Batches of ready crops through the program's eval forward, back to
back, with the eval loops' drain: the poses of a batch are copied to
host memory while the next batches run, and a batch counts once its
copy has landed, at most ``drain_depth`` batches behind the newest.

The check compares the rotations, translations and sizes of every batch
of the window with the reference's answer for its pool batch, and the
NOCS points of each pool batch's first answer and of a sample of the
others drawn from the seed.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import compare, models, traffic as gen
from benchmark.harness.runner import (Runner as Base, module_range, sync,
                                      torch_generator)
from benchmark.harness.weights import torch_seed

POSE_KEYS = ("pred_rotation", "pred_translation", "pred_size")


class Runner(Base):
    def make_traffic(self) -> None:
        cfg, t = self.cfg, self.traffic
        g = torch_generator(self.device, torch_seed(self.seed, 2))
        self.pool_dev = [gen.crop_batch(t["batch"], cfg["sample_num"],
                                        cfg["img_size"], cfg["num_category"],
                                        g, self.device)
                         for _ in range(t["pool"])]
        self.order = gen.rng(self.seed, 3).permutation(t["pool"])
        self.qo_draw = gen.rng(self.seed, 4)

    def make_program(self) -> None:
        self.program = models.program(self.cfg, self.seed, self.device, False,
                                      self.cfg["serve_dtype"])
        for i in range(self.traffic["pool"]):
            self._forward(i)
        sync(self.device)

    @torch.inference_mode()
    def _forward(self, i: int) -> dict:
        return self.program(self.pool_dev[i])

    def _next(self, j: int) -> int:
        return int(self.order[j % len(self.order)])

    def _loop(self, more, on_done) -> None:
        """Forwards while ``more()``; each batch's poses are copied out and
        ``on_done(i, host poses, end_points)`` runs once they have landed,
        at most ``drain_depth`` batches behind."""
        pending, j = [], 0
        while more():
            i = self._next(j)
            j += 1
            t0 = time.perf_counter()
            ep = self._forward(i)
            self.host_s.append(time.perf_counter() - t0)
            host = [ep[k].to("cpu", non_blocking=True) for k in POSE_KEYS]
            ev = torch.cuda.Event() if self._cuda else None
            if ev is not None:
                ev.record()
            pending.append((i, host, ep, ev))
            while len(pending) > self.traffic["drain_depth"]:
                self._land(pending.pop(0), on_done)
        while pending:
            self._land(pending.pop(0), on_done)

    def _land(self, item, on_done) -> None:
        i, host, ep, ev = item
        if ev is not None:
            ev.synchronize()
        on_done(i, host, ep)

    @property
    def _cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def run(self, window) -> dict:
        self.answers, self.qo, self.host_s = [], [], []
        seen = set()
        b = self.traffic["batch"]

        def done(i, host, ep):
            window.add(b)
            self.answers.append((i, *host))
            if i not in seen or self.qo_draw.random() < self.traffic["qo_sample"]:
                self.qo.append((i, ep["pred_qo"]))
            seen.add(i)

        window.open()
        self._loop(window.more, done)
        self.counts = {"attempted": len(self.answers),
                       "batches": len(self.answers), "poses": window.units}
        return {"batch_poses_per_s": window.rate()}

    def trace(self, window) -> dict:
        n = self.traffic["trace_items"]
        count = iter(range(n))
        with module_range(self.program, "forward"):
            for j in range(2):
                self._forward(self._next(j))
            sync(self.device)
            with window():
                self._loop(lambda: next(count, None) is not None,
                           lambda *a: None)
                sync(self.device)
        return {"items": n, "units": n * self.traffic["batch"]}

    def reference_answers(self, precision: str) -> list[dict]:
        model = models.reference(self.cfg, self.seed, self.device, False,
                                 precision)
        block, out = self.traffic["check_block"], []
        with torch.no_grad():
            for x in self.pool_dev:
                parts = [model({k: v[a:a + block] for k, v in x.items()})
                         for a in range(0, len(x["pts"]), block)]
                out.append({k: torch.cat([p[k].float().cpu() for p in parts])
                            for k in (*POSE_KEYS, "pred_qo", "rot6d")})
        del model
        return out

    def check(self, verdict, control: str | None = None) -> None:
        truth = self.reference_answers("float32")
        if control is not None:
            got = self.reference_answers(control)
            answers = [(i, *(a[k] for k in POSE_KEYS)) for i, a in enumerate(got)]
            qo = [(i, a["pred_qo"]) for i, a in enumerate(got)]
        else:
            answers = self.answers
            qo = [(i, q.float().cpu()) for i, q in self.qo]
        prog = {k: [a[1 + j] for a in answers] for j, k in enumerate(POSE_KEYS)}
        ref = {k: [truth[a[0]][k] for a in answers] for k in POSE_KEYS}
        compare.add_pose_numbers(verdict, prog, ref,
                                 [truth[a[0]]["rot6d"] for a in answers])
        verdict.add("qo_gap", compare.gap([q for _, q in qo],
                                          [truth[i]["pred_qo"] for i, _ in qo]))

    @property
    def precision(self) -> str:
        return self.cfg["serve_dtype"]
