"""The training loop: epochs over mixed syn + real batches (counterpart of
``istnet_tpu/train/solver.py``), on one device or data parallel.

Each iteration takes one batch of each loader, concatenates them
(``concat_batches``: one step on the ``syn_bs + real_bs`` rows equals the
reference's batch-size-weighted pair of losses, every term being a batch
mean), splits it into inputs and labels (``split_batch``) and takes one
``train_step``. With ``train_dataset.use_device_preprocess`` the loaders
yield raw arrays and the flat raw batch goes to the device unsplit: the
step's ``preprocess_fn`` (``data/device_preprocess.py``) makes its inputs
and labels there. With ``use_device_aug`` the step's ``augment_fn``
(``data/device_augment.py``) applies the box stretch and the rigid motion;
the other augmentations exist only on the host, so a config that asks for
them with it is refused. Each epoch resamples the datasets and holds the
reference's contract of exactly ``num_mini_batch_per_epoch`` iterations;
every 5th epoch writes a checkpoint.

The steps run under the config's ``compute_dtype`` (float32 or bfloat16),
which the Solver sets as ``cli/train.py`` does; the float64 policy of the
CPU parity tests, which no config names, is kept. The inputs stay in the
parameters' float32 under bf16, as JAX's Solver leaves them: each layer
casts on its own, and the geometry reads float32 points.

The host never waits on the card inside an epoch but for the metrics: the
loss parts stay device tensors and are read (``.item()``) ``pipeline_depth``
steps late, the LR comes from ``TrainConfig.lr(step)`` on the host, and
each batch is copied through a fresh pinned buffer with
``non_blocking=True`` (a fresh one, so that no buffer is reused under a
pending copy). Every ``per_write`` iterations the running averages of the
loss parts and of ``T_data`` (waiting for the batch and copying it),
``T_dispatch`` (enqueueing the step) and ``T_iter`` (the loop's period) go
to the log and the scalar writer. Under a profiler ``T_data``'s stretch is
the span ``solver.data`` (``utils/tracing.py``).

Data parallel: in a process group (``parallel/multihost.py``, one process
a device) the Solver wraps the model with ``parallel.mesh.wrap_dp``
whatever the world size (global-batch BatchNorm, averaged gradients), its
loaders carrying this rank's share of the global batch (``cli/train.py``).
FSDP: ``parallel: {fsdp: N [, dp: M]}`` with N > 1 lays the world out as a
``(dp, fsdp)`` mesh (``fsdp_mesh_shape``, JAX's checks and errors; ``dp``
defaults to ``world // fsdp``); the Solver then takes a model that
``parallel.mesh.shard_state_fsdp`` sharded over that mesh and an optimizer
built after it, wraps nothing, and writes sharded checkpoints.
Each rank's dropout and device-pipeline draws come from a generator seeded
from ``rd_seed`` and its rank, so that ranks draw differently for different
rows, as JAX draws over the global batch. The loss parts are averaged over
the ranks when they are drained (one small collective, ``pipeline_depth``
steps late): every rank then logs JAX's global-batch metrics. Rank 0 alone
feeds the scalar writer; plain checkpoints are rank 0's, behind a
barrier.
"""

from __future__ import annotations

import collections
import itertools
import time

import numpy as np
import torch

from istnet_tpu_torch.data.device_augment import make_device_augment
from istnet_tpu_torch.data.device_preprocess import make_train_preprocess
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.parallel import multihost
from istnet_tpu_torch.parallel.collectives import all_reduce_mean
from istnet_tpu_torch.parallel.mesh import is_sharded, wrap_dp
from istnet_tpu_torch.train import checkpoints
from istnet_tpu_torch.train.train_state import TrainConfig, train_step
from istnet_tpu_torch.utils import tracing
from istnet_tpu_torch.utils.logging import LogBuffer, MetricWriter

LABEL_KEYS = ("rotation_label", "translation_label", "size_label", "qo")
INPUT_KEYS = ("rgb", "pts", "choose", "category_label", "qo", "sym_info")
CHECKPOINT_EVERY = 5
# seeds of a rank's streams: rd_seed + rank * RANK_SEED_STRIDE (the JAX
# CLI's per-host loader seeds, istnet_tpu/cli/train.py:191)
RANK_SEED_STRIDE = 7919


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
    """Numpy leaves of a split (``{"inputs", "labels"}``) or a flat raw
    batch -> tensors on ``device``, floats in ``float_dtype`` but the raw
    depth, which stays float32 (the fill runs in float32); to a card
    through a fresh pinned buffer, without waiting. The span ``h2d`` and
    the counter ``h2d.bytes`` (``utils/tracing.py``)."""
    def put(key: str, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        tracing.count("h2d.bytes", t.numel() * t.element_size())
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        return (t.to(float_dtype) if t.is_floating_point()
                and key != "depth_raw" else t)
    with tracing.span("h2d"):
        return {k: ({kk: put(kk, vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else put(k, v))
                for k, v in batch.items()}


def in_dtype(batch: dict, float_dtype: torch.dtype) -> dict:
    """A ``{"inputs", "labels"}`` batch with its float tensors in
    ``float_dtype``."""
    return {part: {k: v.to(float_dtype) if v.is_floating_point() else v
                   for k, v in leaves.items()}
            for part, leaves in batch.items()}


def device_pipeline(config, float_dtype: torch.dtype):
    """The step's ``(preprocess_fn, augment_fn)`` for ``config``'s
    ``train_dataset`` / ``train_dataloader``, each None where the config
    keeps that part on the host. The jitter's 0.005 clamp is fixed, as the
    reference fixes it (its config's ``shift_range`` is read by nothing)."""
    td = config.get("train_dataset") or {}
    dl = config.get("train_dataloader") or {}
    preprocess_fn = augment_fn = None
    if td.get("use_device_preprocess", False):
        preprocess = make_train_preprocess(
            img_size=int(td.get("img_size", 192)),
            sample_num=int(td.get("sample_num", 1024)),
            use_fill_miss=bool(dl.get("use_fill_miss", True)))

        def preprocess_fn(raw: dict, generator) -> dict:
            return in_dtype(preprocess(raw, generator), float_dtype)
    if td.get("use_device_aug", False):
        for k in ("aug_bc_pro", "aug_pc_pro", "aug_nl_pro"):
            if float(td.get(k, 0.0)) > 0.0:
                raise ValueError(
                    f"use_device_aug supports only bb/rt augs; {k} > 0 "
                    "requires the host path (use_shape_aug)")
        augment_fn = make_device_augment(float(td.get("aug_bb_pro", 0.3)),
                                         float(td.get("aug_rt_pro", 0.3)))
    return preprocess_fn, augment_fn


def fsdp_mesh_shape(parallel, world: int,
                    global_batch: int) -> tuple[int, int] | None:
    """``(dp, fsdp)`` of a config's ``parallel: {fsdp: N [, dp: M]}`` over
    ``world`` processes (one a device), None where ``fsdp`` is absent or
    1 (DDP or one device). Raises JAX's errors (``istnet_tpu/train/
    solver.py:87-108``): ``fsdp`` over the device count, a mesh that does
    not cover the world, a global batch the mesh does not divide."""
    par = parallel or {}
    fsdp = int(par.get("fsdp", 1))
    if fsdp <= 1:
        return None
    dp = int(par.get("dp", 0)) or world // fsdp
    if dp < 1:
        raise ValueError(f"parallel.fsdp = {fsdp} exceeds the {world} "
                         f"available devices (dp computes to {dp}); use "
                         "fsdp <= device_count")
    if dp * fsdp > world:
        raise ValueError(f"mesh {dp}x{fsdp} needs {dp * fsdp} devices, "
                         f"have {world}")
    if dp * fsdp != world:
        raise ValueError(f"multi-process mesh must cover all devices: "
                         f"dp*fsdp = {dp * fsdp} != {world}")
    if global_batch % (dp * fsdp):
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"mesh size {dp}x{fsdp}")
    return dp, fsdp


class Solver:
    """Trains ``model`` (in train mode, on its device) with ``optimizer``
    built by ``make_optimizer`` for ``train_cfg``. ``config`` is the YAML
    config (``max_epoch``, ``per_write``, ``pipeline_depth``, ``rd_seed``,
    ``train_dataset``, ``parallel``, ``compute_dtype``); ``step`` is the
    step count to start from (a resumed run's), ``start_epoch`` the first
    epoch to run. In a process group ``self.model`` is the DDP wrapper,
    or under FSDP the sharded model as given."""

    def __init__(self, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                 train_cfg: TrainConfig, config, syn_loader=None,
                 real_loader=None, logger=None, log_dir: str | None = None,
                 start_epoch: int = 1, step: int = 0):
        self.logger = logger
        self.rank = multihost.process_index()
        self.parallel = torch.distributed.is_initialized()
        world = multihost.process_count()
        local_bs = sum(loader.batch_size for loader in (syn_loader, real_loader)
                       if loader is not None) or 1
        mesh_shape = fsdp_mesh_shape(config.get("parallel"), world,
                                     local_bs * world)
        if mesh_shape is not None:
            if not is_sharded(model):
                raise ValueError("parallel.fsdp > 1 takes a model sharded by "
                                 "parallel.shard_state_fsdp, and an optimizer "
                                 "built after it")
            dp, fsdp = mesh_shape
            self._log(f"parallel: FSDP mesh dp={dp} fsdp={fsdp} ({world} "
                      "process(es))")
            self.model = model
        else:
            self.model = wrap_dp(model) if self.parallel else model
        self.optimizer = optimizer
        self.train_cfg = train_cfg
        self.syn_loader = syn_loader
        self.real_loader = real_loader
        self.log_buffer = LogBuffer()
        self.writer = MetricWriter(log_dir if self.rank == 0 else None)
        self.log_dir = log_dir
        self.per_write = int(config.get("per_write", 50))
        # steps the host runs ahead of the metrics it reads
        self.pipeline_depth = int(config.get("pipeline_depth", 2))
        self.max_epoch = int(config.max_epoch)
        self.iters_per_epoch = int(config.get("num_mini_batch_per_epoch", 4000))
        self.start_epoch = start_epoch
        self.step = int(step)
        self.records: list[dict] = []
        if precision.compute_dtype() != torch.float64:
            precision.set_compute_dtype(precision.dtype_named(
                config.get("compute_dtype", "float32")))
        param = next(model.parameters())
        self.device, self.dtype = param.device, param.dtype
        self.preprocess_fn, self.augment_fn = device_pipeline(config,
                                                              self.dtype)
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.get("rd_seed", 1)) + self.rank * RANK_SEED_STRIDE)

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
            if self.parallel:
                values = all_reduce_mean(torch.stack(list(parts.values())))
                parts = dict(zip(parts, values))
            record.update({k: v.item() for k, v in parts.items()})
            self.log_buffer.update({k: v for k, v in record.items()
                                    if k not in ("epoch", "step", "lr")})

        def end_iteration(now: float) -> None:
            # an iteration lasts from its start to the next one's (or to the
            # drain that ends a window)
            records[-1]["T_iter"] = now - t_start

        batches = enumerate(iters)
        t_data0 = time.perf_counter()
        while True:
            with tracing.span("solver.data"):
                got = next(batches, None)
                if got is not None:
                    i, (syn_np, real_np) = got
                    merged = (concat_batches(syn_np, real_np)
                              if real_np is not None else syn_np)
                    if self.preprocess_fn is None:
                        merged = split_batch(merged)
                    batch = to_device(merged, self.device, self.dtype)
            if got is None:
                break
            if records:
                end_iteration(t_data0)
            t_start = t_data0
            t0 = time.perf_counter()
            parts = train_step(self.model, self.optimizer, batch, self.step,
                               self.generator, self.train_cfg,
                               self.preprocess_fn, self.augment_fn)
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
