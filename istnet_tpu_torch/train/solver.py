"""The training loop: epochs over mixed syn + real batches (counterpart of
``istnet_tpu/train/solver.py``), on one device.

Each iteration takes one batch of each loader, concatenates them
(``concat_batches``: one step on the ``syn_bs + real_bs`` rows equals the
reference's batch-size-weighted pair of losses, every term being a batch
mean), splits it into inputs and labels (``split_batch``) and takes one
``train_step``. Each epoch resamples the datasets and holds the reference's
contract of exactly ``num_mini_batch_per_epoch`` iterations; every 5th
epoch writes a checkpoint.

The host never waits on the card inside an epoch but for the metrics: the
loss parts stay device tensors and are read (``.item()``) ``pipeline_depth``
steps late, the LR comes from ``TrainConfig.lr(step)`` on the host, and
each batch is copied through a fresh pinned buffer with
``non_blocking=True`` (a fresh one, so that no buffer is reused under a
pending copy). Every ``per_write`` iterations the running averages of the
loss parts and of ``T_data`` (waiting for the batch and copying it),
``T_dispatch`` (enqueueing the step) and ``T_iter`` (the loop's period) go
to the log and the scalar writer.
"""

from __future__ import annotations

import collections
import itertools
import time

import numpy as np
import torch

from istnet_tpu_torch.data.dataset import DEVICE_PIPELINE_NOT_YET
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.train.train_state import TrainConfig, train_step
from istnet_tpu_torch.utils.logging import LogBuffer, MetricWriter

LABEL_KEYS = ("rotation_label", "translation_label", "size_label", "qo")
INPUT_KEYS = ("rgb", "pts", "choose", "category_label", "qo", "sym_info")
CHECKPOINT_EVERY = 5
PARALLEL_NOT_YET = ("parallel: {fsdp: N > 1} (FSDP) is not ported yet: "
                    "ROADMAP.md queue 1, item 8")


def split_batch(np_batch: dict) -> dict:
    """A collated numpy batch -> ``{"inputs": ..., "labels": ...}``."""
    inputs = {k: np_batch[k] for k in INPUT_KEYS if k in np_batch}
    labels = {k: np_batch[k] for k in LABEL_KEYS if k in np_batch}
    return {"inputs": inputs, "labels": labels}


def concat_batches(a: dict, b: dict) -> dict:
    """Row-wise concatenation of the array leaves of two collated batches."""
    return {k: np.concatenate([a[k], b[k]], axis=0)
            for k in a if isinstance(a[k], np.ndarray)}


def to_device(batch: dict, device: torch.device,
              float_dtype: torch.dtype) -> dict:
    """Numpy leaves -> tensors on ``device``, floats in ``float_dtype``;
    to a card through a fresh pinned buffer, without waiting."""
    def put(a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        return t.to(float_dtype) if t.is_floating_point() else t
    return {part: {k: put(v) for k, v in leaves.items()}
            for part, leaves in batch.items()}


class Solver:
    """Trains ``model`` (in train mode, on its device) with ``optimizer``
    built by ``make_optimizer`` for ``train_cfg``. ``config`` is the YAML
    config (``max_epoch``, ``per_write``, ``pipeline_depth``, ``rd_seed``,
    ``train_dataset``, ``parallel``); ``step`` is the step count to start
    from (a resumed run's), ``start_epoch`` the first epoch to run."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 train_cfg: TrainConfig, config, syn_loader=None,
                 real_loader=None, logger=None, log_dir: str | None = None,
                 start_epoch: int = 1, step: int = 0):
        par = config.get("parallel") or {}
        if int(par.get("fsdp", 1)) > 1:
            raise NotImplementedError(PARALLEL_NOT_YET)
        td = config.get("train_dataset") or {}
        if td.get("use_device_preprocess", False) or td.get("use_device_aug", False):
            raise NotImplementedError(DEVICE_PIPELINE_NOT_YET)
        self.model = model
        self.optimizer = optimizer
        self.train_cfg = train_cfg
        self.logger = logger
        self.syn_loader = syn_loader
        self.real_loader = real_loader
        self.log_buffer = LogBuffer()
        self.writer = MetricWriter(log_dir)
        self.log_dir = log_dir
        self.per_write = int(config.get("per_write", 50))
        # steps the host runs ahead of the metrics it reads
        self.pipeline_depth = int(config.get("pipeline_depth", 2))
        self.max_epoch = int(config.max_epoch)
        self.iters_per_epoch = int(config.get("num_mini_batch_per_epoch", 4000))
        self.start_epoch = start_epoch
        self.step = int(step)
        self.records: list[dict] = []
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.get("rd_seed", 1)))

    def _log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.info(msg)
        else:
            print(msg)

    def solve(self) -> list[dict]:
        """Epochs ``start_epoch .. max_epoch``; returns every iteration's
        record (``train_epoch``'s), kept as ``self.records``."""
        self.records = records = []
        for epoch in range(self.start_epoch, self.max_epoch + 1):
            records += self.train_epoch(epoch)
            if epoch % CHECKPOINT_EVERY == 0 and self.log_dir is not None:
                checkpoints.save_checkpoint(f"{self.log_dir}/ckpt", epoch,
                                            self.model, self.optimizer,
                                            self.step)
                self._log(f"saved checkpoint at epoch {epoch}")
        self.writer.close()
        return records

    def train_epoch(self, epoch: int) -> list[dict]:
        """One epoch of ``num_mini_batch_per_epoch`` iterations. Returns a
        record per iteration: ``epoch``, ``step`` (its step count), ``lr``,
        the loss parts, ``T_data``, ``T_dispatch`` and ``T_iter`` in
        seconds."""
        for loader in (self.syn_loader, self.real_loader):
            if loader is not None and getattr(loader.dataset, "num_img_per_epoch", -1) != -1:
                loader.dataset.reset()
        # the reference's epoch is exactly num_mini_batch_per_epoch
        # iterations: fail fast on a loader that is provably short
        for name, loader in (("syn", self.syn_loader), ("real", self.real_loader)):
            if loader is None:
                continue
            try:
                n = len(loader)
            except TypeError:
                continue
            if n < self.iters_per_epoch:
                raise ValueError(
                    f"{name} loader provides {n} batches but the epoch "
                    f"contract is {self.iters_per_epoch} iterations; size the "
                    "dataset with num_img_per_epoch = iters * batch")
        iters = zip(self.syn_loader, self.real_loader) if self.real_loader else (
            (b, None) for b in self.syn_loader)
        iters = itertools.islice(iters, self.iters_per_epoch)

        records: list[dict] = []
        inflight = collections.deque()   # (record, device loss parts)
        t_start = 0.0                    # the current iteration's start

        def drain_one() -> None:
            record, parts = inflight.popleft()
            record.update({k: v.item() for k, v in parts.items()})
            self.log_buffer.update({k: v for k, v in record.items()
                                    if k not in ("epoch", "step", "lr")})

        def end_iteration(now: float) -> None:
            # an iteration lasts from its start to the next one's (or to the
            # drain that ends a window)
            records[-1]["T_iter"] = now - t_start

        t_data0 = time.perf_counter()
        for i, (syn_np, real_np) in enumerate(iters):
            if records:
                end_iteration(t_data0)
            t_start = t_data0
            merged = concat_batches(syn_np, real_np) if real_np is not None else syn_np
            batch = to_device(split_batch(merged), self.device, self.dtype)
            t0 = time.perf_counter()
            parts = train_step(self.model, self.optimizer, batch, self.step,
                               self.generator, self.train_cfg)
            t1 = time.perf_counter()
            records.append({"epoch": epoch, "step": self.step,
                            "lr": self.train_cfg.lr(self.step),
                            "T_data": t0 - t_data0, "T_dispatch": t1 - t0})
            self.step += 1
            inflight.append((records[-1], parts))
            while len(inflight) > self.pipeline_depth:
                drain_one()

            if (i + 1) % self.per_write == 0:
                end_iteration(time.perf_counter())
                while inflight:
                    drain_one()
                avg = self.log_buffer.average()
                self._log(f"epoch {epoch} iter {i + 1}/{self.iters_per_epoch} "
                          + " ".join(f"{k}={v:.4f}" for k, v in sorted(avg.items())))
                self.writer.add_scalars("train/", avg, self.step)
                self.log_buffer.clear()
            t_data0 = time.perf_counter()
        if inflight:
            end_iteration(time.perf_counter())
            while inflight:
                drain_one()
        if len(records) < self.iters_per_epoch and self.logger is not None:
            self.logger.warning(
                f"epoch {epoch} ran {len(records)}/{self.iters_per_epoch} iters — "
                "loaders exhausted early; size datasets with num_img_per_epoch "
                "= iters * batch to honor the reference epoch contract")
        return records
