"""Build the production-shape IST-Net, its inputs, its train batches and its
raw frames.

Counterpart of ``__graft_entry__.entry()`` / ``_make_inputs``: the full-width
``ISTNet`` (6 classes, SA npoints 512/256/128/64) on an explicit device, and
a batch of instance crops (B=32, N=1024 points, 192 x 192 RGB) made from a
numpy ``RandomState(seed)`` exactly as the JAX entry makes them.

Every builder runs on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``, the plain versions of the kernels), and
raises without a card rather than fall back to the CPU.

``build_serving_model`` sets a compute policy first, as ``bench.py:96-99``
sets the bf16 deployment precision before ``entry()``.
``build_train_model`` and ``make_train_batch`` give the train step's model
and batches at the training width, B=24 (``syn_bs`` 18 + ``real_bs`` 6 of
``config/ist_net_default.yaml``).

``make_train_raw_batch`` is the raw batch of the train step's device
pipeline (``TrainingDataset(device_preprocess=True)``'s arrays), as
``tools/train_bench.py::make_synth_raw_batch`` makes it.

``build_encoder`` is the RGB encoder of any trunk backend on its own, its
BatchNorm statistics those of a seeded batch; ``random_resnet_state_dict``
stands in for an ImageNet checkpoint of any
trunk backend (torchvision's keys, seeded random values).

``dryrun_multichip`` is ``__graft_entry__.dryrun_multichip``'s data-parallel
half: one DDP step over n processes at its tiny shapes.

``make_frame`` and ``build_device_forward`` are the serving path's entry:
a synthetic raw 480 x 640 RGB-D frame with instance masks, and the function
that takes such a frame to poses on the model's device
(``eval/test_loop.py::make_device_forward``).

Weights are random: torch's default layer init drawn from a
``torch.Generator`` (the ResNet trunk's convs with the reference's
normal(0, sqrt(2/n)) init), then BatchNorm statistics and affines and the
PReLU slopes set to non-trivial values from a numpy seed, so that a swapped
or skipped normalisation changes the outputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from istnet_tpu_torch.models.ist_net import ISTNet
from istnet_tpu_torch.nn import precision
from istnet_tpu_torch.nn.layers import BatchNorm, Dropout2d, PReLU
from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet, ResNetTrunk

BATCH, NPOINTS, IMG, NCLASS = 32, 1024, 192, 6
TRAIN_BATCH = 24
SA_NPOINTS = (512, 256, 128, 64)
# images whose batch statistics set build_encoder's BN running statistics
CALIBRATION_BATCH = 4


def _input_arrays(b: int, n: int, img: int, train: bool, seed: int) -> dict:
    rng = np.random.RandomState(seed)
    arrays = {
        "rgb": rng.rand(b, img, img, 3).astype(np.float32),
        "pts": rng.randn(b, n, 3).astype(np.float32) * 0.1,
        "choose": rng.randint(0, img * img, size=(b, n)).astype(np.int32),
        "category_label": rng.randint(0, NCLASS, size=(b,)).astype(np.int32),
    }
    if train:
        arrays["qo"] = rng.randn(b, n, 3).astype(np.float32) * 0.1
    return arrays


def on_device(device: str | torch.device, name: str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises: the entry points run on the card unless asked for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name}: no CUDA card; pass device='cpu' for "
                           f"the plain versions on the CPU")
    return device


def make_inputs(b: int = BATCH, n: int = NPOINTS, img: int = IMG,
                seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """The eval inputs of ``__graft_entry__._make_inputs(train=False)``."""
    device = on_device(device, "make_inputs")
    return {k: torch.from_numpy(v).to(device)
            for k, v in _input_arrays(b, n, img, False, seed).items()}


def make_train_batch(b: int = TRAIN_BATCH, n: int = NPOINTS, img: int = IMG,
                     seed: int = 0, device: str | torch.device = "cuda"
                     ) -> dict:
    """``{"inputs", "labels"}``: the inputs of
    ``__graft_entry__._make_inputs(train=True)`` (with ``qo``) and the
    labels ``__graft_entry__.dryrun_multichip`` pairs them with (identity
    rotations, zero translations, unit sizes, ``qo``)."""
    device = on_device(device, "make_train_batch")
    inputs = {k: torch.from_numpy(v).to(device)
              for k, v in _input_arrays(b, n, img, True, seed).items()}
    labels = {
        "rotation_label": torch.eye(3, device=device).expand(b, 3, 3).clone(),
        "translation_label": torch.zeros(b, 3, device=device),
        "size_label": torch.ones(b, 3, device=device),
        "qo": inputs["qo"],
    }
    return {"inputs": inputs, "labels": labels}


@torch.no_grad()
def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """torch's default Conv/Linear init (kaiming-uniform a=sqrt(5): bound
    1/sqrt(fan_in), bias likewise), the trunk convs normal(0, sqrt(2/n))
    with n = kh*kw*out; every draw from ``generator``."""
    trunk_convs = {id(m) for t in model.modules() if isinstance(t, ResNetTrunk)
                   for m in t.modules() if isinstance(m, nn.Conv2d)}
    for m in model.modules():
        if isinstance(m, (nn.Conv1d, nn.Conv2d, nn.Linear)):
            w = m.weight
            if id(m) in trunk_convs:
                n = w.shape[0] * math.prod(w.shape[2:])
                w.normal_(0.0, math.sqrt(2.0 / n), generator=generator)
            else:
                bound = 1.0 / math.sqrt(w[0].numel())
                w.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                bound = 1.0 / math.sqrt(w[0].numel())
                m.bias.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def perturb_eval_stats_(model: nn.Module, seed: int = 0) -> None:
    """Non-trivial BN running stats / affines and PReLU slopes."""
    rng = np.random.RandomState(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            c = m.weight.numel()
            for t, v in ((m.running_mean, rng.randn(c) * 0.1),
                         (m.running_var, rng.uniform(0.5, 1.5, c)),
                         (m.weight, 1.0 + rng.randn(c) * 0.1),
                         (m.bias, rng.randn(c) * 0.1)):
                t.copy_(torch.from_numpy(v.astype(np.float32)))
        elif isinstance(m, PReLU):
            m.weight.fill_(float(rng.uniform(0.1, 0.4)))


def random_resnet_state_dict(backend: str = "resnet18", seed: int = 0
                             ) -> dict[str, torch.Tensor]:
    """A torchvision-layout ResNet state dict of ``backend`` (the keys of
    torchvision's ``resnet<depth>().state_dict()``, classifier included)
    with random values made from ``seed``, on the CPU: the stand-in for an
    ImageNet checkpoint, which is never downloaded."""
    trunk = ResNetTrunk(backend)
    init_weights_(trunk, torch.Generator().manual_seed(seed))
    perturb_eval_stats_(trunk, seed)
    return {k: v.detach().clone() for k, v in trunk.state_dict().items()}


@torch.no_grad()
def build_encoder(backend: str = "resnet18",
                  device: str | torch.device = "cuda", seed: int = 0,
                  img: int = IMG) -> ModifiedResnet:
    """The RGB encoder of ``backend`` on its own, in eval mode on
    ``device``: random weights made from ``seed`` as ``build_model`` makes
    them, then every BatchNorm's running statistics set to the batch
    statistics of one train-mode forward (dropout off) of a seeded batch
    of CALIBRATION_BATCH images of ``img`` x ``img``. Without that, a
    deep trunk at random weights grows its eval activations block by block
    (some 1e9-fold over resnet152's 50 blocks), where a trained one keeps
    them normalised."""
    device = on_device(device, "build_encoder")
    model = ModifiedResnet(backend)
    init_weights_(model, torch.Generator().manual_seed(seed))
    perturb_eval_stats_(model, seed)
    model = model.to(device).train()
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.eval()
    x = _input_arrays(CALIBRATION_BATCH, 1, img, False, seed)["rgb"]
    old = precision.compute_dtype()
    precision.set_compute_dtype(torch.float32)
    try:
        model(torch.from_numpy(x).to(device))
    finally:
        precision.set_compute_dtype(old)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.running_mean.copy_(m.batch_mean)
            m.running_var.copy_(m.batch_var)
    return model.eval()


def build_model(device: str | torch.device = "cuda", seed: int = 0,
                sa_npoints=SA_NPOINTS, nclass: int = NCLASS,
                freeze_world_enhancer: bool = False) -> ISTNet:
    """Full-width ``ISTNet`` in eval mode on ``device``, random weights
    made from ``seed``."""
    device = on_device(device, "build_model")
    model = ISTNet(nclass=nclass, sa_npoints=sa_npoints,
                   freeze_world_enhancer=freeze_world_enhancer)
    init_weights_(model, torch.Generator().manual_seed(seed))
    perturb_eval_stats_(model, seed)
    return model.eval().to(device)


def build_train_model(device: str | torch.device = "cuda", seed: int = 0,
                      freeze_world_enhancer: bool = False,
                      sa_npoints=SA_NPOINTS,
                      dtype: torch.dtype = torch.float32) -> ISTNet:
    """``build_model`` in train mode, under the compute policy ``dtype``
    (float32 as ``config/ist_net_default.yaml`` trains, or bf16 as
    ``config/ist_net_2048pt_dp.yaml``; the parameters are float32 under
    both). The policy is global, as in ``build_serving_model``."""
    device = on_device(device, "build_train_model")
    precision.set_compute_dtype(dtype)
    return build_model(device, seed, sa_npoints,
                       freeze_world_enhancer=freeze_world_enhancer).train()


def build_serving_model(dtype: torch.dtype = torch.bfloat16,
                        device: str | torch.device = "cuda", seed: int = 0,
                        sa_npoints=SA_NPOINTS) -> ISTNet:
    """``build_model`` under the compute policy ``dtype`` (bf16 by default,
    the deployment precision). The policy is global and read at every
    forward; ``precision.set_compute_dtype`` restores another one."""
    device = on_device(device, "build_serving_model")
    precision.set_compute_dtype(dtype)
    return build_model(device, seed, sa_npoints)


FRAME_H, FRAME_W = 480, 640


def make_train_raw_batch(b: int = TRAIN_BATCH, seed: int = 0,
                         device: str | torch.device = "cuda") -> dict:
    """A raw train batch from a numpy ``RandomState(seed)``, the arrays of
    ``tools/train_bench.py::make_synth_raw_batch``: per sample a box of
    depth 800-1200 mm with 15% holes on an empty frame, its mask 5 pixels
    inside it, noise rgb, the REAL camera, identity rotations, ``t = (0, 0,
    1)`` m, random sizes, ``sym_info`` 0."""
    device = on_device(device, "make_train_raw_batch")
    h, w = FRAME_H, FRAME_W
    rng = np.random.RandomState(seed)
    depth = np.zeros((b, h, w), np.float32)
    masks = np.zeros((b, h, w), bool)
    bboxes = np.zeros((b, 4), np.int32)
    for i in range(b):
        y0, x0 = rng.randint(40, h - 240), rng.randint(40, w - 240)
        hh, ww = rng.randint(80, 200), rng.randint(80, 200)
        depth[i, y0:y0 + hh, x0:x0 + ww] = 800 + 400 * rng.rand(hh, ww)
        hole = rng.rand(hh, ww) < 0.15
        depth[i, y0:y0 + hh, x0:x0 + ww][hole] = 0
        masks[i, y0 + 5:y0 + hh - 5, x0 + 5:x0 + ww - 5] = True
        bboxes[i] = [y0 + 5, x0 + 5, y0 + hh - 5, x0 + ww - 5]
    arrays = {
        "depth_raw": depth,
        "rgb_raw": (rng.rand(b, h, w, 3) * 255).astype(np.uint8),
        "mask_raw": masks,
        "bbox": bboxes,
        "intrinsics": np.tile(np.asarray(
            [591.0125, 590.16775, 322.525, 244.11084], np.float32), (b, 1)),
        "category_label": rng.randint(0, 6, size=b).astype(np.int64),
        "rotation_label": np.tile(np.eye(3, dtype=np.float32), (b, 1, 1)),
        "translation_label": np.asarray([[0.0, 0.0, 1.0]] * b, np.float32),
        "size_label": np.abs(rng.rand(b, 3).astype(np.float32)) + 0.05,
        "sym_info": np.zeros((b, 4), np.int32),
    }
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def make_frame(seed: int = 0, k: int = 6, n_tiny: int = 0,
               hole_share: float = 0.2) -> dict:
    """A synthetic raw frame as ``TestDataset(device_preprocess=True)``
    yields it, from a numpy ``RandomState(seed)``: ``rgb_full`` (480, 640,
    3) uint8, ``depth_raw`` (480, 640) float32 mm (a slanted surface with a
    box per instance in front of it, ``hole_share`` of the pixels and a band
    at the top missing), ``masks`` (k, 480, 640) bool, ``bboxes`` (k, 4)
    int32 [y1, x1, y2, x2], ``category_label`` (k,) int64. The last
    ``n_tiny`` instances have 3 x 3 masks: fewer valid pixels than the
    loops' ``min_points``."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W].astype(np.float32)
    depth = 1400.0 + 0.5 * xx + 0.8 * yy
    masks = np.zeros((k, FRAME_H, FRAME_W), bool)
    bboxes = np.zeros((k, 4), np.int32)
    cols = max(1, int(np.ceil(np.sqrt(k * FRAME_W / FRAME_H))))
    rows = -(-k // cols)
    cell_h, cell_w = (FRAME_H - 80) // rows, FRAME_W // cols
    for i in range(k):
        size = 3 if i >= k - n_tiny else int(rng.randint(
            40, max(41, min(cell_h, cell_w) - 8)))
        y0 = 80 + (i // cols) * cell_h + int(rng.randint(0, cell_h - size))
        x0 = (i % cols) * cell_w + int(rng.randint(0, cell_w - size))
        masks[i, y0:y0 + size, x0:x0 + size] = True
        bboxes[i] = (y0, x0, y0 + size, x0 + size)
        depth[y0:y0 + size, x0:x0 + size] = (
            700.0 + 60.0 * i + 0.3 * xx[y0:y0 + size, x0:x0 + size])
    depth[rng.rand(FRAME_H, FRAME_W) < hole_share] = 0.0
    depth[:60] = 0.0
    for i in range(k - n_tiny, k):      # the tiny masks keep their depth
        y0, x0 = bboxes[i, :2]
        depth[y0:y0 + 3, x0:x0 + 3] = 700.0 + 60.0 * i
    return {
        "rgb_full": (rng.rand(FRAME_H, FRAME_W, 3) * 255).astype(np.uint8),
        "depth_raw": depth.astype(np.float32),
        "masks": masks,
        "bboxes": bboxes,
        "category_label": rng.randint(0, NCLASS, size=(k,)).astype(np.int64),
    }


def build_device_forward(dtype: torch.dtype = torch.float32,
                         device: str | torch.device = "cuda", seed: int = 0,
                         sa_npoints=SA_NPOINTS, img_size: int = IMG,
                         sample_num: int = NPOINTS):
    """The serving path from a raw frame: ``(model, fn)`` with ``fn(rgb_full,
    depth_raw, masks, bboxes, category, generator=None, v=None) ->
    (end_points, n_valid)`` (``eval/test_loop.py::make_device_forward``),
    the model built by ``build_serving_model`` under the policy ``dtype``,
    the REAL camera's intrinsics. It runs on the card, through the
    kernels, and raises without one; ``device="cpu"`` asks for the plain
    versions on the CPU."""
    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
    from istnet_tpu_torch.eval.test_loop import make_device_forward

    device = on_device(device, "build_device_forward")
    model = build_serving_model(dtype, device, seed, sa_npoints)
    return model, make_device_forward(model, REAL_INTRINSICS,
                                      img_size=img_size,
                                      sample_num=sample_num)


DRYRUN_SA_NPOINTS, DRYRUN_POINTS, DRYRUN_IMG = (32, 16, 8, 8), 128, 48
# float32 sums in another order, amplified by BNs whose batch variance is
# tiny at 128 points (measured 3.3e-5 at n = 2 on the CPU)
DRYRUN_LOSS_RTOL = 1e-4
DRYRUN_TIMEOUT_S = 600


def _dryrun_rank(rank: int, world: int, store, device: str) -> tuple:
    """One rank of ``dryrun_multichip``: its rows of the batch, one step of
    the DDP-wrapped model; for ``world >= 4`` and even, then one step of a
    fresh model sharded over a ``(2, world // 2)`` FSDP mesh. Returns the
    losses averaged over the ranks (the FSDP one None where it did not
    run)."""
    from istnet_tpu_torch.parallel import collectives, mesh, multihost
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)

    if device == "cpu":
        torch.set_num_threads(1)
    dev = multihost.initialize(device, store=store, rank=rank,
                               world_size=world)
    try:
        cfg = TrainConfig()
        losses = []
        for fsdp in (False, True):
            if fsdp and (world < 4 or world % 2):
                losses.append(None)
                continue
            model, batch = _dryrun_setup(world, dev)
            if fsdp:
                model = mesh.shard_state_fsdp(
                    mesh.make_mesh_2d(2, world // 2, dev.type), model)
            opt = make_optimizer(model, cfg)
            parts = train_step(model if fsdp else mesh.wrap_dp(model), opt,
                               mesh.shard_batch_2d(batch, rank, world), 0,
                               torch.Generator(device=dev).manual_seed(rank),
                               cfg)
            losses.append(float(collectives.all_reduce_mean(parts["total"])))
        return tuple(losses)
    finally:
        multihost.shutdown()


def _dryrun_setup(b: int, device) -> tuple:
    """The dry run's model (train mode, dropout off: the ranks draw other
    masks than one process would) and its global batch of ``b`` rows."""
    from istnet_tpu_torch.nn.layers import Dropout2d

    model = build_model(device, seed=0, sa_npoints=DRYRUN_SA_NPOINTS).train()
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.eval()
    return model, make_train_batch(b, DRYRUN_POINTS, DRYRUN_IMG, seed=1,
                                   device=device)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> float:
    """One full data-parallel train step over ``n_devices`` processes at
    ``__graft_entry__.dryrun_multichip``'s shapes (B = n, N = 128, 48 x 48,
    SA npoints 32/16/8/8): NCCL over ``cuda:0..n-1`` (n cards needed), or
    gloo over n CPU processes with ``device="cpu"``. The loss must be finite,
    the same on every rank, and equal within ``DRYRUN_LOSS_RTOL`` to one
    process's step on the whole batch. For ``n >= 4`` and even, the same
    step of the model sharded over a ``(2, n // 2)`` FSDP mesh too: finite,
    the same on every rank, within JAX's ``1e-3 + 1e-3 * |loss|`` of the DP
    loss. Returns the DP loss."""
    from istnet_tpu_torch.parallel import multihost
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)

    if device != "cpu":
        on_device(device, "dryrun_multichip")
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip: need {n_devices} cards, "
                               f"have {torch.cuda.device_count()}")
    ranks = multihost.spawn(_dryrun_rank, n_devices, device,
                            timeout=DRYRUN_TIMEOUT_S)
    model, batch = _dryrun_setup(n_devices, torch.device(device))
    cfg = TrainConfig()
    want = float(train_step(model, make_optimizer(model, cfg), batch, 0,
                            torch.Generator(device=device), cfg)["total"])
    losses = [r[0] for r in ranks]
    loss = losses[0]
    if not np.isfinite(loss) or len(set(losses)) != 1 or not np.isclose(
            loss, want, rtol=DRYRUN_LOSS_RTOL, atol=0.0):
        raise AssertionError(f"dryrun_multichip({n_devices}): DP losses "
                             f"{losses}, one process {want}")
    print(f"dryrun_multichip({n_devices}): DP OK, loss={loss:.4f} (one "
          f"process {want:.4f}), step=1")
    fsdp_losses = [r[1] for r in ranks]
    if fsdp_losses[0] is not None:
        loss2 = fsdp_losses[0]
        if not np.isfinite(loss2) or len(set(fsdp_losses)) != 1 or not (
                abs(loss2 - loss) < 1e-3 + 1e-3 * abs(loss)):
            raise AssertionError(f"dryrun_multichip({n_devices}): FSDP "
                                 f"losses {fsdp_losses}, DP loss {loss}")
        print(f"dryrun_multichip({n_devices}): FSDP(2x{n_devices // 2}) OK, "
              f"loss={loss2:.4f}")
    return loss
