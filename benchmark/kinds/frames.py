"""Raw RGB-D frames through the program's serving function, in a closed
loop with one client: each frame is handed over when the last one's poses
are back in host memory.

The serving function is ``istnet_tpu_torch.eval.test_loop.
make_device_forward`` over the configuration's model at its serving
precision: depth completion, square crop, in-mask sampling with the
benchmark's uniforms, back-projection, resize and the eval forward, for
the frame's instances padded to their bucket. A frame is timed from the
call to the moment its rotations, translations, sizes and ``n_valid`` are
in host memory. An instance is posed when its ``n_valid`` exceeds the
traffic's ``min_points`` (the serving loop drops the others after the
pass).

The check compares every answer of the window with the reference's
answer for its pool frame (the same frame and uniforms give the same
answer), and the NOCS points of each pool frame's first answer and of a
sample of the others drawn from the seed.
"""

from __future__ import annotations

import time

import torch

from benchmark.harness import compare, models, traffic as gen
from benchmark.harness.runner import (Runner as Base, function_range,
                                      module_range, sync, torch_generator)
from benchmark.harness.trace import span
from benchmark.harness.weights import torch_seed
from benchmark.reference import preprocess as ref_pre

POSE_KEYS = ("pred_rotation", "pred_translation", "pred_size")


class Runner(Base):
    def make_traffic(self) -> None:
        cfg, t = self.cfg, self.traffic
        self.pool = gen.frame_pool(t, self.seed)
        g = torch_generator(self.device, torch_seed(self.seed, 2))
        self.v = [torch.rand(len(f["masks"]), cfg["sample_num"], generator=g,
                             device=self.device) for f in self.pool]
        self.order = gen.rng(self.seed, 3).permutation(len(self.pool))
        self.qo_draw = gen.rng(self.seed, 4)

    def make_program(self) -> None:
        from istnet_tpu_torch.eval.test_loop import make_device_forward
        cfg = self.cfg
        self.program = models.program(cfg, self.seed, self.device, False,
                                      cfg["serve_dtype"])
        self.fn = make_device_forward(self.program, gen.REAL_INTRINSICS,
                                      img_size=cfg["img_size"],
                                      sample_num=cfg["sample_num"])
        for i in range(len(self.pool)):          # every bucket the pool has
            self._read(*self._serve(i))

    def _serve(self, i: int):
        f = self.pool[i]
        return self.fn(f["rgb_full"], f["depth_raw"], f["masks"],
                       f["bboxes"], f["category_label"], v=self.v[i])

    def _read(self, ep, n_valid):
        outs = [ep[k].to("cpu", non_blocking=True) for k in POSE_KEYS]
        outs.append(n_valid.to("cpu", non_blocking=True))
        sync(self.device)
        return outs

    def _next(self, j: int) -> int:
        return int(self.order[j % len(self.order)])

    def run(self, window) -> dict:
        self.answers, self.qo, self.host_s = [], [], []
        seen = set()
        window.open()
        j = 0
        while window.more():
            i = self._next(j)
            j += 1
            window.item()
            t0 = time.perf_counter()
            ep, n_valid = self._serve(i)
            self.host_s.append(time.perf_counter() - t0)
            r, t, s, n = self._read(ep, n_valid)
            k = self.pool[i]["k"]
            window.done(int((n[:k] > self.traffic["min_points"]).sum()))
            self.answers.append((i, r[:k], t[:k], s[:k], n[:k]))
            if i not in seen or self.qo_draw.random() < self.traffic["qo_sample"]:
                self.qo.append((i, ep["pred_qo"][:k]))
            seen.add(i)
        self.counts = {"attempted": len(self.answers),
                       "frames": len(self.answers), "poses": window.units}
        return {"poses_per_s": window.rate(), "frame_p95_ms": window.p95_ms()}

    def trace(self, window) -> dict:
        from istnet_tpu_torch.eval import test_loop
        n, poses = self.traffic["trace_items"], 0
        with module_range(self.program, "forward"), \
                function_range(test_loop, "fill_missing", "fill"), \
                function_range(test_loop, "preprocess_shared_image",
                               "preprocess"):
            for j in range(2):       # the profiler may lose its first events
                self._read(*self._serve(self._next(j)))
            with window():
                for j in range(n):
                    i = self._next(j)
                    with span("serve"):
                        ep, n_valid = self._serve(i)
                    with span("readback"):
                        out = self._read(ep, n_valid)
                    k = self.pool[i]["k"]
                    poses += int((out[3][:k] > self.traffic["min_points"]).sum())
        return {"items": n, "units": poses}

    # -- the check ---------------------------------------------------------

    def reference_answers(self, precision: str) -> list[dict]:
        """The reference's answer for each pool frame's instances (its
        real rows), computed in blocks of instances."""
        cfg, dev = self.cfg, self.device
        model = models.reference(cfg, self.seed, dev, False, precision)
        rows, outs = [], []
        with torch.no_grad():
            for i, f in enumerate(self.pool):
                k = f["k"]
                filled = ref_pre.fill_missing(
                    torch.as_tensor(f["depth_raw"], device=dev))
                x = ref_pre.preprocess_frame(
                    torch.as_tensor(f["rgb_full"], device=dev), filled,
                    torch.as_tensor(f["masks"][:k], device=dev),
                    torch.as_tensor(f["bboxes"][:k], device=dev),
                    gen.REAL_INTRINSICS, self.v[i][:k], cfg["img_size"])
                x["category_label"] = torch.as_tensor(
                    f["category_label"][:k], device=dev)
                rows.append(x)
            cat = {key: torch.cat([x[key] for x in rows])
                   for key in ("rgb", "pts", "choose", "category_label",
                               "n_valid")}
            block = self.traffic["check_block"]
            for a in range(0, len(cat["pts"]), block):
                out = model({key: v[a:a + block] for key, v in cat.items()})
                outs.append({key: out[key].float().cpu()
                             for key in (*POSE_KEYS, "pred_qo", "rot6d")})
        merged = {key: torch.cat([o[key] for o in outs]) for key in outs[0]}
        merged["n_valid"] = cat["n_valid"].cpu()
        answers, at = [], 0
        for f in self.pool:
            answers.append({key: v[at:at + f["k"]] for key, v in merged.items()})
            at += f["k"]
        del model
        return answers

    def check(self, verdict, control: str | None = None) -> None:
        truth = self.reference_answers("float32")
        min_points = self.traffic["min_points"]
        if control is not None:
            got = self.reference_answers(control)
            answers = [(i, *(a[k] for k in POSE_KEYS), a["n_valid"])
                       for i, a in enumerate(got)]
            qo = [(i, a["pred_qo"]) for i, a in enumerate(got)]
        else:
            answers, qo = self.answers, [(i, q.float().cpu())
                                         for i, q in self.qo]
        n_diff = max(int((n.long() - truth[i]["n_valid"].long()).abs().max())
                     for i, *_, n in answers)
        prog, ref = {k: [] for k in POSE_KEYS}, {k: [] for k in POSE_KEYS}
        rot6d = []
        for i, r, t, s, n in answers:
            kept = n > min_points
            for key, val in zip(POSE_KEYS, (r, t, s)):
                prog[key].append(val[kept])
                ref[key].append(truth[i][key][kept])
            rot6d.append(truth[i]["rot6d"][kept])
        kept_qo = [(q[truth[i]["n_valid"] > min_points],
                    truth[i]["pred_qo"][truth[i]["n_valid"] > min_points])
                   for i, q in qo]
        verdict.add("n_valid_diff", n_diff)
        compare.add_pose_numbers(verdict, prog, ref, rot6d)
        verdict.add("qo_gap", compare.gap([a for a, _ in kept_qo],
                                          [b for _, b in kept_qo]))

    @property
    def precision(self) -> str:
        return self.cfg["serve_dtype"]
