#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``istnet_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and nvcc.
Phases, each printing its own lines; any failure exits nonzero:

1. device: the card's name and power limit (nvidia-smi), torch / CUDA /
   nvcc versions;
2. build: compile the CUDA kernels from ``istnet_tpu_torch/csrc`` and the
   host depth fill from ``istnet_tpu_torch/native``;

then for each compute policy, float32 and bf16 (the deployment precision):

3. kernels: each kernel against its plain PyTorch version on the card, at
   every shape the main path gives it (bf16: the fused SA kernel at SA
   stages 2-4 and at stage 1's shape, and the bf16 variants of grouping,
   FP interpolation and fold; the eval BN pass at each of the forward's
   call sites, on the maps and statistics a forward hands it, bit-equal);
4. forward: the full-width ISTNet eval forward (B=32, N=1024, 192x192)
   serving 3 batches, with the launch counts of every kernel;
5. reference: the same model and inputs at B=2, on the card against the
   port's plain-PyTorch CPU forward under the same policy (bf16: also the
   drift of the bf16 forward from the float32 one on the card);
6. timings: the B=32 forward and its sections, each kernel against its
   plain version (CUDA events after warmup), the fused SA kernel and the
   fold also stage by stage (U and the main kernel; the GEMM and the
   interpolation), FPS as device us a call and ns a step, the grouping as
   device us a call beside kernel 8's query of the same lists and
   ``torch.index_select`` of the same rows (a yardstick of a plain gather,
   never in ``library_ms``), the FP interpolation as device us a call by
   FP stage, each summed over the path; under bf16 also the fused SA
   kernel at stage 1 against the unfused stage 1;

then the float32 train step (``train/train_state.py``):

7. train kernels: every kernel the train step launches (the forward's FPS,
   grouping and FP interpolation; the backward's 8: multi-radius ball
   query, the grouping scatter, 10: 3-NN with the interpolation weights,
   the interpolation scatter) against its plain version at B=24 on the
   step's inputs: a train batch's points through the camera extractor's
   stages and its NOCS points through the world extractor's, every SA and
   FP stage with its radii; kernel 10 also writing distances (indices and
   distances equal, weights within 2 ulp), the two scatters also with bf16
   cotangents (off the f32 path), each of their cases launched twice and
   held bit-equal; the two autograd Functions with bf16 cotangents at the
   same shapes against autograd through the plain ops; then each kernel's
   ms per step against its plain version's, the two scatters also against
   PyTorch's ``index_add_`` on the same rows (a yardstick that the port
   never calls), with their device us stage by stage, the inversion's
   launch apart from the gather's, kernels 3, 8 and 10 a call by stage,
   10 beside ``torch.cdist`` + ``topk`` of the same points (a yardstick of
   another formula, never in ``library_ms``);
8. train steps: the full-width model at B=24, N=1024, 192x192 takes 3 steps
   of the default recipe and 2 of the frozen one; each step's loss and
   gradients are finite, the trained parameters move, every BatchNorm's
   running statistics take the scheduled EMA, and every kernel launches as
   often as the step's path asks;
9. train reference: one step on the card against the same step of the
   port's CPU path (same weights and batch, dropout off, B=2, small
   npoints): the loss, the gradients and the updated state; then one step
   at full width (B=2, N=1024, 192x192, SA npoints 512/256/128/64) on the
   card against the port's float64 CPU step: the loss parts and the
   gradients, and a second card step from the same state repeating the
   first bit for bit;
10. train timings: median step ms over 10 steps with its forward, backward
   and update split (CUDA events), peak memory, for the default recipe and
   the frozen one;

then the bf16 train policy (``config/ist_net_2048pt_dp.yaml``'s):

19. train bf16: every kernel of the bf16 step at its shapes against its
   plain version (the grouping writing bf16 from bf16 features, the FP
   stages on bf16 features, both scatters on bf16 cotangents); the
   per-point gather's bf16 backward card against CPU bit for bit; 3
   default and 2 frozen steps at B=24 with the checks of 8; one full-width
   step at B=2 against the CPU float64 step within the BF16_FULL_* bounds
   and a second card step bit-equal; the default and the frozen step's
   median ms, split, peak memory and launches a step;

then 2048 points (the 2048-point config's ``sample_num``):

20. eval 2048: the eval kernels at N = 2048's shapes against their plain
   versions, the B=32 forward under float32 and bf16 (launches, outputs,
   card against CPU at B=2 within 2e-4 / 5e-3, ms);
21. train 2048: the bf16 step's kernels at N = 2048 (frozen recipe), 2
   frozen bf16 steps at B=24 with the checks of 8, the step's median ms
   and peak memory; the train-side device sampler at ``sample_num`` 2048,
   card against CPU on SAMPLER_FRAMES raw frames;

then the serving path from a raw frame (``eval/test_loop.py``), under the
float32 policy and, for 11-13, the bf16 one too:

11. depth fill: kernel 11 against its plain version at (1, 480, 640) and
   (24, 480, 640) on frames with 35% holes, an empty top band and empty
   columns, at a width that is no multiple of 128, at 5 x 5 and on an
   all-zero frame: without the bilateral filter equal, with it within
   1e-5 m; and against the port's OpenCV pipeline on one frame within 1 mm,
   that OpenCV fill's host ms beside kernel 11's on the same frame;
   then every kernel of the path at the serving bucket of 8 (kernel 11's
   device time launch by launch on the serving frame, the 35%-hole frame
   and 24 such frames; kernel 8's query by SA stage beside the grouping);
12. device forward: one synthetic 480 x 640 frame of 6 instances (one with
   a 9-pixel mask) padded to a bucket of 8 through depth fill, crop, sample,
   back-projection, resize and the full-width eval forward; outputs finite,
   ``R^T R = I``, ``n_valid`` of the padded rows 0, launch counts of the one
   call; per-frame times of its parts;
13. device reference: the same path at a small model on the card against
   the CPU, same uniforms: ``choose`` and ``n_valid`` equal, points within
   1e-5 m, poses within the eval phases' bounds;
14. loops: ``test_func_device`` and ``test_func_device_batched`` (batch 32,
   kb 16) over a synthetic tree of 24 frames in a temporary directory write
   one pkl per frame with the same kept instances, ``nocs_map.evaluate``
   gives finite APs; frames/s of each loop and the card's busy share;

then the training loop through ``cli/train.py`` at full width (the shipped
configs' B = 18 + 6, N = 1024, 192 x 192, SA npoints 512/256/128/64, their
epochs cut) over synthetic Real + CAMERA trees of 8 scenes in a temporary
directory:

15. train loop: ``config/ist_net_default.yaml`` for 5 epochs of 4 steps
   (checkpoint at epoch 5, 4 loader threads a loader): every loss finite,
   every kernel launched ``TRAIN_PER_STEP`` times a step; median
   ``T_iter`` / ``T_data`` / ``T_dispatch`` and samples/s over epochs 2-5
   beside phase 10's bare step, peak memory, the host's CPU count;
16. resume: ``--checkpoint_epoch 5`` with ``max_epoch`` 6: the restored
   model and optimizer bit-equal to the state that wrote the checkpoint,
   the first step count 20 at ``TrainConfig.lr(20)``, epoch 6 to its end
   with finite losses, the card's busy share over it (torch.profiler);
17. two-phase: PoseNetGT (``config/posenet_gt_default.yaml``, 5 epochs of
   2 steps, ``POSENET_PER_STEP`` launches a step), its world extractor
   moved into ``config/ist_net_freeze_world_enhancer.yaml``'s IST-Net (5
   epochs of 2 steps, ``FROZEN_PER_STEP``), the frozen extractor's
   parameters bit-equal to phase 1's after phase 2, ``cli/test.py`` from
   the epoch-5 checkpoint on the card: finite APs; each loop's numbers as
   in 15 and its busy share;
18. device loop: ``config/ist_net_device_pipeline.yaml`` (raw frames; the
   fill on kernel 11, crop, sampling, jitter, ColorJitter, ``qo`` and the
   FS-Net augmentation inside the step) for 5 epochs of 4 steps: every
   loss finite, ``DEVICE_LOOP_PER_STEP`` launches a step (the train step's
   and kernel 11 once), the numbers of 15 beside phase 15's, the busy share
   over one more, profiled, epoch; on one raw batch of the trees (B = 24):
   the card's preprocessing against the CPU's with the same draws
   (``choose`` equal, points and ``qo`` within 1e-5 m, rgb within 2e-3 of
   a level), then its device us, launches and host enqueue ms part by
   part; kernel 11 at the path's shape against its plain version;
22. 2048 config (run between 17 and 18, from 17's PoseNetGT checkpoint):
   ``config/ist_net_2048pt_dp.yaml`` (frozen, bf16, 2048 points) through
   ``cli/train.py`` for 5 epochs of 2 steps, its world enhancer from phase
   17's epoch-5 PoseNetGT checkpoint, launches ``FROZEN_PER_STEP`` a step,
   the numbers of 15 and its busy share; ``cli/test.py`` on its epoch-5
   checkpoint at ``test.sample_num`` 2048 under bf16: finite APs.

then data parallelism on the one card (``istnet_tpu_torch/parallel``):

23. FPS past 2048 points: kernel 1 against its plain version at N = 2049,
   4096, 8192 (16 warps of registers) and 20000 (the stream kernel), B = 8,
   indices equal; kernel, plain and device time a call;
24. DDP world 1: ``multihost.initialize`` under torchrun's variables on a
   free port (NCCL), 3 default and 3 frozen steps at B = 24 through
   ``wrap_dp`` bit-equal to the plain card step from the same state (every
   loss part and state tensor), launches as the plain step's; the default
   step's median ms, DDP and plain in turns, and peak memory;
25. two ranks on one card: two spawned processes under gloo, both on
   ``cuda:0``, each with 12 rows of a B = 24 batch (global-batch
   BatchNorm), one full-width step against one process's B = 24 card step
   from the same state, dropout off: loss parts and gradients within phase
   9's full-width bounds, both ranks' updated state bit-equal, each
   rank's peak memory;
26. (run after 18) ``cli/train.py`` under torchrun (world 1, NCCL) over
   phase 15's trees, 5 epochs of one step and the epoch-5 checkpoint (the
   reference keys), launches counted in the torchrun process; then
   ``cli/test.py --devices 1`` on it: finite APs;
27. eval DP: ``eval_forward_dp`` over ``[cuda:0, cuda:0]`` against the
   unsplit B = 32 f32 forward within 2e-4, launches twice a forward's, and
   the eval kernels at the replicas' B = 16 against their plain versions.

then the leftovers of the JAX package (their seconds printed together):

28. trunks: the RGB encoder alone with each of resnet18/34/50/101/152
   (``entry.build_encoder``) at B = 32, 192 x 192, f32 and bf16: the dense
   forward and the sparse head at 1024 pixels, finite, the fold kernel
   once a forward, and held against its plain version on each trunk's
   own up_2 input at phase 3's bounds; card against CPU at B = 2 reported
   against phase 5's
   bounds, and both against the CPU's float64 forward (the card's error at
   most twice the CPU's); ms, parameters, peak memory; a train-mode
   forward and backward at B = 24 with finite gradients, ms and memory;
29. pretrained backbone: a seeded torchvision-layout resnet18 dict through
   ``cli/convert_torch_resnet.py``, then ``cli/train.py
   --pretrained_backbone`` for 2 steps at full width over phase 15's kind
   of trees, the trunk equal to the file before step 1, TRAIN_PER_STEP
   launches a step; a resnet50-layout dict loaded into its encoder;
30. data prep: ``cli/data_processing.py``'s four stages over
   ``build_raw_prep_tree``, the RANSAC on the card, against a CPU run:
   lists and Real / test labels equal, CAMERA-train within 1e-5; each
   stage's seconds; the RANSAC's ms and peak memory on the card, and the
   per-instance fit's ms on the card and the CPU, at 4,800, 20,000 and
   260,000 points;
31. vis: ``cli/test.py --vis --vis_axes --vis_labels`` on the card over
   phase 14's kind of tree: a PNG a frame, each pixel-equal to
   ``draw_detections`` of its result pickle;
32. profiling: ``utils/profiling.trace`` around 3 B = 32 f32 forwards,
   ``parse_trace`` / ``aggregate_ops``: the last forward's FPS, grouping,
   FP and fold kernels as many as their wrappers' launches; ``timed``
   against ``cuda_ms`` within the spread of 5 rounds.

then FSDP (``parallel/mesh.py::shard_state_fsdp``, ``fully_shard`` over a
``(dp, fsdp)`` mesh):

33. FSDP world 1: ``multihost.initialize`` under torchrun's variables
   (NCCL), a ``(1, 1)`` mesh; 3 steps at B = 24 of the f32 default and
   frozen recipes and the bf16 default one, sharded, against the plain
   card step from the same state, batches and generator: loss parts, the
   last step's gradients and every state tensor (gathered) bit-equal, or
   within phase 9's full-width bounds with the differences printed;
   launches as the plain step's; the f32 default step's median ms, FSDP
   and plain in turns, and peak memory;
34. sharded checkpoint: phase 33's f32 FSDP state saved with DCP, restored
   by ``restore_checkpoint_sharded`` into a fresh sharded model and
   optimizer, the next step bit-equal to the unbroken run's; then
   ``restore_for_eval`` of the same directory into the plain eval model on
   the card: the B = 32 eval forward launches kernels 1-4 and equals the
   forward of the gathered weights bit for bit; save and restore seconds;
35. two ranks on one card with the model sharded over a ``(1, 2)`` mesh:
   phase 25 under FSDP (gloo on ``cuda:0``), the ranks' gathered state one
   digest, each rank's peak memory beside phase 25's.

then the bench (``bench_torch.py`` and ``tools/{train,eval}_bench_torch.py``):

36. bench: kernels 1-5 against their plain versions at B = 128 under
   float32 and bf16 (the bench's new shapes), timed there; the bench's
   measurements at 2 rounds of few calls (both policies at B = 32 and
   128, the device-pipeline and bare train steps), the launch counts reset
   before and read after: every rate finite and above 0, ``bench.py``'s
   keys in the record, every kernel of the paths launched; the bench's
   B = 32 forward bit-equal to phase 4's model under each policy on the
   same seed; rows 0-31 of the B = 128 forward within phase 5's bound of
   the B = 32 forward of those rows; the three eval loops of
   ``tools/eval_bench_torch.py`` over 64 images, every pose finite.

then the last modules of the JAX package (their seconds printed together):

37. native fill: the host C++ depth fill (``istnet_tpu_torch/native``,
   built with ``g++`` by phase 2) on the serving frame and a half-empty
   480 x 640 frame against the OpenCV chain and kernel 11 within 0.01 mm,
   the default ``fill_missing`` bit-equal to the native call; host ms a
   frame of both fills beside the CPU's model;
38. converter: ``cli/convert_torch_istnet.py`` at full width, ``.pth`` ->
   ``.npz`` -> ``.pth`` for ``ISTNet``, ``PoseNetGT`` and a frozen
   checkpoint without the world pose head: the export equal to the
   original bit for bit, the B = 32 eval forward from the ``.npz`` and
   from the export bit-equal to the original weights' forward, kernels
   1-4 launched as counted.

Before the last line come the card's name and power limit (first line) and a
JSON object of per-kernel results with each kernel's bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import importlib.metadata
import json
import os
import re
import subprocess
import sys
import time

from istnet_tpu_torch.utils.profiling import cuda_ms, device_us, no_gc, timed

# (N, npoint) of the 4 SA stages
FPS_SHAPES = ((1024, 512), (512, 256), (256, 128), (128, 64))
# (N, M, feature channels) of the 4 SA stages; the output has 3 + C channels
BQG_SHAPES = ((1024, 512, 0), (512, 256, 64), (256, 128, 128), (128, 64, 256))
# (N unknown, M known, C) of the 4 FP stages, in call order
FP_SHAPES = ((128, 64, 512), (256, 128, 512), (512, 256, 256),
             (1024, 512, 256))
# up_2: (h, w, cin, cout)
FOLD_SHAPE = (48, 48, 256, 64)
NSAMPLES = (16, 32)
BATCH = 32
SERVED_BATCHES = 3
FP_REL_TOL = 1e-5       # normwise: max|kernel - plain| / max|plain|
FOLD_TOL = 1e-4         # max|kernel - plain| / max(1, max|plain|)
CPU_ATOL = 2e-4         # card vs CPU forward, absolute, every output
# bf16: (N, M, feature channels, MLP) of the fused SA stages 2-4, then the
# stage-1 shape (no features; the model keeps stage 1 unfused)
SA_FUSED_SHAPES = ((512, 256, 64, (32, 32, 64)), (256, 128, 128, (64, 64, 128)),
                   (128, 64, 256, (128, 128, 256)))
SA1_SHAPE = (1024, 512, 0, (16, 16, 32))
BF16_FP_TOL = 2.0 ** -8  # normwise, as FP_REL_TOL
# bf16 gradients, normwise: one rounding of float32 sums taken in another
# order can land one bf16 ulp apart, 2^-7 of the value at most (measured
# 0.03125 at a largest value of 6.9 on the H100)
BF16_GRAD_TOL = 2.0 ** -7
BF16_FOLD_TOL = 1e-2    # as FOLD_TOL
SA_TOL = 2e-2           # max|kernel - plain| / max(1, max|plain|)
BF16_CPU_ATOL = 5e-3    # bf16 card vs bf16 CPU forward (measured <= 8.7e-4)
# the eval BN pass: every BN of the encoder and the camera extractor but
# up_2's (kernel 4's epilogue), and under bf16 but SA 2-4's 18 (kernel 5)
F32_PER_FORWARD = {"fps": 4, "ball_query_group": 4, "fp_interpolate": 4,
                   "fold_upsample": 1, "sa_fused": 0, "bn_eval": 55}
BF16_PER_FORWARD = {"fps": 4, "ball_query_group": 1, "fp_interpolate": 4,
                    "fold_upsample": 1, "sa_fused": 3, "bn_eval": 37}

# the float32 train step at the training width (config/ist_net_default.yaml)
TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG = 24, 1024, 192
TRAIN_SA_NPOINTS = (512, 256, 128, 64)
TRAIN_STEPS, FROZEN_STEPS, TIMED_STEPS = 3, 2, 10
FSDP_TIMING_ROUNDS = 3     # phase 33's plain/fsdp/fsdp/plain turns
SCATTER_TOL = 1e-5      # normwise, as FP_REL_TOL (f32 sums in a fixed
                        # order of their own, the plain versions in theirs)
# launches of one step: forward FPS / grouping / FP in both extractors
# (fold, fused SA and the BN pass are eval-only); backward kernel 8 + grouping scatter
# at SA 2-4 and kernel 10 + interpolation scatter at FP 1-4, of both
# extractors, or of the camera extractor alone in the frozen recipe
TRAIN_PER_STEP = {"fps": 8, "ball_query_group": 8, "fp_interpolate": 8,
                  "fold_upsample": 0, "sa_fused": 0, "ball_query": 6,
                  "group_scatter": 6, "three_nn": 8, "interp_scatter": 8,
                  "depth_fill": 0, "bn_eval": 0}
FROZEN_PER_STEP = {**TRAIN_PER_STEP, "ball_query": 3, "group_scatter": 3,
                   "three_nn": 4, "interp_scatter": 4}
# PoseNetGT: forward FPS / grouping / FP in its camera and world
# extractors; backward in the world extractor alone (the pose head takes
# the RGB and camera features detached)
POSENET_PER_STEP = dict(FROZEN_PER_STEP)
# the device input pipeline (config/ist_net_device_pipeline.yaml): the
# train step's launches and kernel 11 once a step on the raw batch
DEVICE_LOOP_PER_STEP = {**TRAIN_PER_STEP, "depth_fill": 1}
# card vs CPU train preprocessing on one raw batch, same draws: points and
# qo in metres (the fills differ by the bilateral's rounding), ColorJitter's
# rgb in levels of 0..255 (float ops rounded apart around an HSV round trip)
PRE_PTS_TOL, PRE_QO_TOL, PRE_RGB_TOL = 1e-5, 1e-5, 2e-3
# the training loop through cli/train.py (phases 15-17): the shipped
# configs' shapes, epochs cut; synthetic trees of LOOP_SCENES scenes
LOOP_SCENES, LOOP_TEST_FRAMES = 8, 4
LOOP_EPOCHS, LOOP_ITERS, TWO_PHASE_ITERS = 5, 4, 2
REPO = os.path.dirname(os.path.abspath(__file__))
# card vs CPU train step (B=2, N=128, 48x48, SA npoints 32/16/8/8, points
# at std 3 cm so that the camera radii find neighbours at 128 points),
# bounds ~10x over the measurements on the H100:
# - loss parts, relative (measured 1.2e-7);
# - gradients, normwise over all: max|card - cpu| / max|cpu| (9.2e-5);
# - gradients per tensor, normwise, for every tensor whose largest
#   gradient is above REF_GRAD_FLOOR of the largest of all (384 of 396
#   tensors; measured <= 2.6e-2, main_estimator.pose_mlp1.0.weight; the
#   bound sits ~4x over it). Below the floor sit the biases before
#   train-mode BNs (gradients of rounding noise, ~1e-10) and two PReLU
#   slopes (one-element sums that cancel to ~3e-6 of the largest; 0.15);
# - the updated parameters: Adam's first step moves an element by
#   lr * g / (|g| + eps), ~lr whatever |g|, so an element whose gradient is
#   rounding noise takes +-lr on either side; the share of elements whose
#   updates differ by more than 0.1 lr is bounded (measured 0.187%);
# - running statistics, normwise per tensor (5.9e-6)
REF_SA_NPOINTS, REF_BATCH, REF_POINTS, REF_IMG = (32, 16, 8, 8), 2, 128, 48
REF_LOSS_TOL = 1e-5
REF_GRAD_TOL = 1e-3
REF_GRAD_FLOOR = 1e-5
REF_GRAD_TENSOR_TOL = 0.1
REF_UPDATE_SHARE = 1e-2
REF_STATS_TOL = 1e-4
# card float32 vs CPU float64 train step at full width (B=2, N=1024, 192x192,
# SA npoints 512/256/128/64, dropout off), bounds 5-60x over the measurement
# on the H100: loss parts, relative (measured 1.7e-7); gradients normwise
# over all (3.1e-3), and per tensor above REF_GRAD_FLOOR of the largest
# (<= 0.10, rgb_cam_extractor.model.feats.layer3.1.conv1.weight: float32
# convolutions against float64 ones)
FULL_REF_BATCH = 2
FULL_LOSS_TOL = 1e-5
FULL_GRAD_TOL = 2e-2
FULL_GRAD_TENSOR_TOL = 0.5
# the same step under the bf16 policy (config/ist_net_2048pt_dp.yaml's),
# card against CPU float64, bounds ~3-5x over the port's own bf16 drift of
# this step on the CPU (bf16 CPU step against the float64 one, same
# weights and batch; PERF.md §6): loss parts, relative (measured
# 2.0e-3); gradients normwise over all (0.32); per tensor above
# REF_GRAD_FLOOR, the median tensor (0.54; a tensor whose largest gradient
# is rounding noise, a BN affine, drifts by up to 2.1 of it)
BF16_FULL_LOSS_TOL = 1e-2
BF16_FULL_GRAD_TOL = 1.0
BF16_FULL_GRAD_TENSOR_TOL = 1.5
# the train sampler at sample_num 2048, card against CPU: raw frames
SAMPLER_FRAMES = 4

# the serving path from a raw frame: one 480 x 640 frame of 6 instances in a
# bucket of 8; the loops over a synthetic tree
FRAME_SHAPE = (480, 640)
SERVE_INSTANCES, SERVE_BUCKET = 6, 8
LOOP_FRAMES, LOOP_INSTANCES, LOOP_BATCH, LOOP_KB = 24, 3, 32, 16
# kernel 11 against its plain version, metres: every max, min and median is
# exact; the bilateral's expf, 13 products and divide round on their own
# (measured 1.4e-6 on the H100)
DEPTH_FILL_TOL = 1e-5
DEPTH_FILL_CV2_TOL_MM = 1.0
# card vs CPU device preprocessing, metres (the fills differ by the above)
REF_PTS_TOL = 1e-5
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): device
# memory bytes/s, float32 FLOP/s outside the tensor cores, bf16 FLOP/s
HBM_BPS, F32_OPS, BF16_OPS = 3.35e12, 67e12, 989e12


@contextlib.contextmanager
def policy(dtype):
    """Run the block under the compute policy ``dtype``, then restore."""
    from istnet_tpu_torch.nn import precision
    old = precision.compute_dtype()
    precision.set_compute_dtype(dtype)
    try:
        yield
    finally:
        precision.set_compute_dtype(old)


def run(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          check=True)
    return proc.stdout.strip()


def phase_device() -> dict:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"])
    print(smi.splitlines()[0])
    from istnet_tpu_torch.ops import _build
    nvcc = run([_build.find_nvcc(), "--version"]).splitlines()[-1]
    try:
        triton = importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        triton = "not installed"
    print(f"torch {torch.__version__} cuda {torch.version.cuda} | nvcc {nvcc} "
          f"| triton {triton}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from istnet_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.library()
    info = _build.build_info
    print(f"[build] {_build.LIB_NAME} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {info.get('seconds', 0.0):.1f} s, cached "
          f"{info.get('cached')})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  " + line.strip())
    # the host depth fill's C++ core, which the host data paths run
    from istnet_tpu_torch import native
    t0 = time.perf_counter()
    native.library()
    print(f"[build] {native.LIB_NAME} (host depth fill) in "
          f"{time.perf_counter() - t0:.1f} s by "
          f"{native.build_info['compiler']}")


def _points(rng, b, n):
    import torch
    return torch.from_numpy((rng.randn(b, n, 3) * 0.1).astype("float32"))


def _f32(a, device):
    import torch
    return torch.from_numpy(a.astype("float32")).to(device)


def _epilogue(rng, cout):
    import numpy as np
    return np.stack([rng.randn(cout) * 0.1,
                     1.0 / np.sqrt(rng.uniform(0.5, 1.5, cout)),
                     1.0 + rng.randn(cout) * 0.1, rng.randn(cout) * 0.1,
                     np.full(cout, 0.25)])


def _eval_shapes(points: int):
    """The FPS, grouping and FP shapes of a forward (eval or train) of
    ``points`` points: SA 1's input and FP 1's output take N; the rest
    keep their N = 1024 shapes (the SA stages sample 512/256/128/64)."""
    return (((points,) + FPS_SHAPES[0][1:],) + FPS_SHAPES[1:],
            ((points,) + BQG_SHAPES[0][1:],) + BQG_SHAPES[1:],
            FP_SHAPES[:-1] + ((points,) + FP_SHAPES[-1][1:],))


def kernel_cases(device, batch: int = 0, points: int = 1024):
    """Per kernel, the argument tuples of its path shapes, on ``device``,
    for a forward of ``points`` points."""
    import numpy as np
    import torch

    from istnet_tpu_torch.models.ist_net import CAM_RADII
    from istnet_tpu_torch.ops import fold_upsample

    batch = batch or BATCH
    fps_shapes, bqg_shapes, fp_shapes = _eval_shapes(points)
    rng = np.random.RandomState(0)
    cases = {"fps": [], "ball_query_group": [], "fp_interpolate": [],
             "fold_upsample": []}
    for n, npoint in fps_shapes:
        cases["fps"].append((_points(rng, batch, n).to(device), npoint))
    for (n, m, cf), radii in zip(bqg_shapes, CAM_RADII):
        xyz = _points(rng, batch, n).to(device)
        feats = (None if cf == 0 else torch.from_numpy(
            rng.randn(batch, n, cf).astype("float32")).to(device))
        cases["ball_query_group"].append(
            (radii, NSAMPLES, xyz, xyz[:, :m].contiguous(), feats))
    for n, m, c in fp_shapes:
        unknown = _points(rng, batch, n).to(device)
        feats = torch.from_numpy(rng.randn(batch, m, c).astype("float32"))
        cases["fp_interpolate"].append(
            (unknown, unknown[:, :m].contiguous(), feats.to(device)))
    h, w, cin, cout = FOLD_SHAPE
    ep = _epilogue(rng, cout)
    # the fold's constants packed ahead, as PSPUpsample hands them over
    cases["fold_upsample"].append(
        (_f32(rng.randn(batch, h, w, cin), device), fold_upsample.pack_fold(
            _f32(rng.uniform(-1, 1, (3, 3, cin, cout)) / np.sqrt(9 * cin),
                 device),
            _f32(rng.randn(cout) * 0.1, device), _f32(ep, device))))
    cases["bn_eval"] = bn_eval_cases(device, torch.float32, batch, points)
    return cases


def bn_eval_cases(device, dtype, batch: int, points: int = 1024) -> list:
    """The eval BN pass's argument tuples at every call site of a
    full-width eval forward of ``batch`` crops under ``dtype``: the maps,
    statistics, residuals and slopes the forward hands it (up_1's map
    permuted in memory, as its einsum leaves it; the PReLU's slope
    detached, so that the wrapper takes it with grad mode on), recorded
    from one forward that runs the pass's plain version."""
    import torch

    from istnet_tpu_torch.entry import build_model, make_inputs
    from istnet_tpu_torch.ops import bn_eval, dispatch
    sites = []

    def record(*args):
        sites.append(tuple(a.detach() if isinstance(a, torch.Tensor) else a
                           for a in args))
        return bn_eval.plain(*args)

    model = build_model(device, seed=21)
    inputs = make_inputs(batch, points, seed=22, device=device)
    real, dispatch.bn_eval = dispatch.bn_eval, record
    try:
        with policy(dtype), torch.inference_mode():
            model(inputs)
    finally:
        dispatch.bn_eval = real
    return sites


def _folded(rng, c_in, channels, device):
    """Random BN-folded (W, b) layers, float32 on ``device``."""
    import numpy as np
    layers = []
    for c_out in channels:
        layers.append((_f32(rng.uniform(-1, 1, (c_in, c_out))
                            * np.sqrt(3.0 / c_in), device),
                       _f32(rng.randn(c_out) * 0.1, device)))
        c_in = c_out
    return tuple(layers)


def kernel_cases_bf16(device, batch: int = 0, points: int = 1024):
    """The bf16 path's cases for a forward of ``points`` points: per kernel
    a list of (argument tuple, on the path). The fused SA case at stage 1's
    shape is #7's function; the model keeps stage 1 unfused, so it is
    checked and timed but off the path. The fold's and the fused SA's
    weights come packed ahead, as the modules hand them over."""
    import numpy as np
    import torch

    from istnet_tpu_torch.models.ist_net import CAM_RADII
    from istnet_tpu_torch.ops import fold_upsample, sa_fused

    batch = batch or BATCH
    bf16 = torch.bfloat16
    rng = np.random.RandomState(1)
    cases = {"ball_query_group": [], "fp_interpolate": [],
             "fold_upsample": [], "sa_fused": []}
    _, bqg_shapes, fp_shapes = _eval_shapes(points)
    n, m, _ = bqg_shapes[0]
    xyz = _points(rng, batch, n).to(device)
    cases["ball_query_group"].append(
        ((CAM_RADII[0], NSAMPLES, xyz, xyz[:, :m].contiguous(), None, bf16),
         True))
    for n, m, c in fp_shapes:
        unknown = _points(rng, batch, n).to(device)
        feats = _f32(rng.randn(batch, m, c), device).to(bf16)
        cases["fp_interpolate"].append(
            ((unknown, unknown[:, :m].contiguous(), feats), True))
    h, w, cin, cout = FOLD_SHAPE
    cases["fold_upsample"].append(
        ((_f32(rng.randn(batch, h, w, cin), device).to(bf16),
          fold_upsample.pack_fold(
              _f32(rng.uniform(-1, 1, (3, 3, cin, cout)) / np.sqrt(9 * cin),
                   device).to(bf16),
              _f32(rng.randn(cout) * 0.1, device).to(bf16),
              _f32(_epilogue(rng, cout), device))), True))
    stages = [(shape, CAM_RADII[i + 1], True)
              for i, shape in enumerate(SA_FUSED_SHAPES)]
    for (n, m, cf, mlp), radii, on_path in stages + [(SA1_SHAPE, CAM_RADII[0],
                                                      False)]:
        xyz = _points(rng, batch, n).to(device)
        feats = (None if cf == 0 else
                 torch.relu(_f32(rng.randn(batch, n, cf), device)).to(bf16))
        folded = sa_fused.pack_folded(
            tuple(_folded(rng, 3 + cf, mlp, device) for _ in NSAMPLES))
        cases["sa_fused"].append(
            ((radii, NSAMPLES, xyz, xyz[:, :m].contiguous(), feats, folded),
             on_path))
    cases["bn_eval"] = [(args, True) for args
                        in bn_eval_cases(device, bf16, batch, points)]
    return cases


def train_kernel_cases(device, points: int = TRAIN_POINTS, bf16: bool = False,
                       frozen: bool = False):
    """The train step's kernels at its shapes: per kernel a list of
    (argument tuple, launches of that case in one default-recipe step, or
    one frozen-recipe step with ``frozen``: the world extractor's backward
    cases are then checked but off the path). ``points``: the clouds' N
    (SA 1's input, FP 1's output); ``bf16``: the bf16 policy's data, the
    grouping writing bf16 from bf16 features, the FP stages interpolating
    bf16 features and both scatters taking bf16 cotangents.
    The inputs follow the path: a train batch's centred points through the
    camera extractor's SA stages and its NOCS points (``qo``) through the
    world extractor's, each stage's centres the plain FPS of its input,
    each FP stage's known points those of the stage below (so part of its
    unknown ones: distances of exactly 0). Features and cotangents are
    random float32 of the stage's widths; the scatters take the indices of
    the plain searches (equal to the kernels', checked in the same phase).
    Kernel 10 runs its weights variant, as the FP backward does. SA stage 1
    has no backward: its points are data."""
    import numpy as np

    from istnet_tpu_torch.entry import make_train_batch
    from istnet_tpu_torch.models.ist_net import CAM_RADII, WORLD_RADII
    from istnet_tpu_torch.ops import pointnet2 as plain

    import torch

    rng = np.random.RandomState(2)
    b = TRAIN_BATCH
    data = torch.bfloat16 if bf16 else torch.float32

    def rand(*shape):
        return _f32(rng.randn(*shape), device).to(data)
    inputs = make_train_batch(b, points, TRAIN_IMG, seed=2,
                              device=device)["inputs"]
    cam = inputs["pts"] - inputs["pts"].mean(dim=1, keepdim=True)
    _, bqg_shapes, fp_shapes = _eval_shapes(points)
    out_dtype = (torch.bfloat16,) if bf16 else ()
    cases = {name: [] for name, k in TRAIN_PER_STEP.items() if k}
    for cloud, radii_list, back in ((cam, CAM_RADII, 1),
                                    (inputs["qo"], WORLD_RADII,
                                     0 if frozen else 1)):
        levels = [cloud]
        for (n, m, cf), radii in zip(bqg_shapes, radii_list):
            xyz = levels[-1]
            new_xyz = plain.gather_points(xyz,
                                          plain.furthest_point_sample(xyz, m))
            levels.append(new_xyz)
            feats = None if cf == 0 else rand(b, n, cf)
            cases["fps"].append(((xyz, m), 1))
            cases["ball_query_group"].append(
                ((radii, NSAMPLES, xyz, new_xyz, feats, *out_dtype), 1))
            if cf == 0:
                continue
            cases["ball_query"].append(((radii, NSAMPLES, xyz, new_xyz),
                                        back))
            idx = plain.ball_query_multi(radii, NSAMPLES, xyz, new_xyz)
            grads = [rand(b, m, ns, 3 + cf) for ns in NSAMPLES]
            cases["group_scatter"].append(((idx, grads, n), back))
        for k, (n, m, c) in enumerate(fp_shapes):
            unknown, known = levels[3 - k], levels[4 - k]
            cases["fp_interpolate"].append(
                ((unknown, known, rand(b, m, c)), 1))
            cases["three_nn"].append(((unknown, known, True), back))
            dist, idx = plain.three_nn(unknown, known)
            weight = plain.three_interpolate_weights(dist)
            cases["interp_scatter"].append(
                ((rand(b, n, c), idx, weight, m), back))
    return cases


def with_bf16_scatter_twins(cases) -> dict:
    """``cases`` with each scatter case followed by its bf16 twin (the
    same call with its cotangents rounded to bf16), which the float32 step
    does not launch."""
    twins = {
        "group_scatter": lambda idx, grads, n: (
            idx, [g.bfloat16() for g in grads], n),
        "interp_scatter": lambda grad, idx, weight, m: (
            grad.bfloat16(), idx, weight, m)}
    return {name: [case for args, k in case_list
                   for case in ((args, k), (twins[name](*args), 0))]
            if name in twins else case_list
            for name, case_list in cases.items()}


def with_three_nn_distances(cases) -> dict:
    """``cases`` with each kernel-10 case followed by its distances variant
    (the same search writing distances in place of the weights), which the
    train step does not launch."""
    return {name: [case for args, k in case_list
                   for case in ((args, k), (args[:2], 0))]
            if name == "three_nn" else case_list
            for name, case_list in cases.items()}


def _dtype(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def _label(name: str, args) -> str:
    if name == "fps":
        return f"N={args[0].shape[1]} npoint={args[1]}"
    if name == "ball_query":
        radii, _, xyz, new_xyz = args
        return f"N={xyz.shape[1]} M={new_xyz.shape[1]} radii={radii}"
    if name == "group_scatter":
        idx, grads, n = args
        return (f"N={n} M={idx[0].shape[1]} C={grads[0].shape[-1]} "
                f"ns={[i.shape[-1] for i in idx]} {_dtype(grads[0])}")
    if name == "three_nn":
        what = "weights" if args[2:] and args[2] else "distances"
        return f"N={args[0].shape[1]} M={args[1].shape[1]} {what}"
    if name == "interp_scatter":
        grad, _, _, m = args
        return f"N={grad.shape[1]} M={m} C={grad.shape[-1]} {_dtype(grad)}"
    if name in ("ball_query_group", "sa_fused"):
        xyz, new_xyz, feats = args[2:5]
        c = 3 + (0 if feats is None else feats.shape[-1])
        return f"N={xyz.shape[1]} M={new_xyz.shape[1]} C={c} radii={args[0]}"
    if name == "fp_interpolate":
        unknown, known, feats = args
        return f"N={unknown.shape[1]} M={known.shape[1]} C={feats.shape[-1]}"
    if name == "depth_fill":
        empty = (args[0] <= 0.01).float().mean().item()
        return f"depth={tuple(args[0].shape)} empty={empty:.1%}"
    if name == "bn_eval":
        x, _, act, residual = args[:4]
        return (f"x={tuple(x.shape)} {_dtype(x)}"
                f"{'' if x.is_contiguous() else ' (permuted)'} "
                f"{'residual + ' if residual is not None else ''}{act}")
    return f"x={tuple(args[0].shape)} cout={args[1].k.shape[-1]}"


def _check(name: str, got, want, bf16: bool) -> float:
    """Max abs error of one kernel case against its plain version; raise if
    it is outside the stated tolerance."""
    import torch
    if name == "fps":
        if not torch.equal(got, want):
            raise AssertionError(f"fps indices differ at {tuple(got.shape)}")
        return 0.0
    if name == "bn_eval":
        # the same arithmetic in the same order: equal in every bit
        ints = torch.int16 if want.element_size() == 2 else torch.int32
        if got.dtype != want.dtype or not torch.equal(
                got.contiguous().view(ints), want.contiguous().view(ints)):
            raise AssertionError(f"bn_eval differs at {tuple(got.shape)} "
                                 f"{got.dtype}")
        return 0.0
    if name == "depth_fill":
        err = (got - want).abs().max().item()
        same_pixels = torch.equal(got > 0.01, want > 0.01)
        if got.dtype != want.dtype or err > DEPTH_FILL_TOL or not same_pixels:
            raise AssertionError(f"depth_fill max abs err {err} m at "
                                 f"{tuple(got.shape)}, same completed pixels: "
                                 f"{same_pixels}")
        return err
    if name == "three_nn weights":
        # idx equal; the weights within 2 ulp of the plain ones (float32
        # sums of 3 in another order)
        (g, gi), (w_, wi) = got, want
        ulp = torch.nextafter(w_.abs(), torch.full_like(w_, float("inf"))) \
            - w_.abs()
        err = (g - w_).abs()
        if not torch.equal(gi, wi) or not (err <= 2 * ulp).all():
            raise AssertionError(f"three_nn weights differ at "
                                 f"{tuple(g.shape)}: indices equal "
                                 f"{torch.equal(gi, wi)}, max "
                                 f"{(err / ulp).max().item()} ulp")
        return err.max().item()
    if name in ("ball_query", "three_nn"):
        # indices (and 3-NN distances) from the same arithmetic: equal
        for g, w_ in zip(got, want):
            if g.dtype != w_.dtype or not torch.equal(g, w_):
                raise AssertionError(f"{name} differs at {tuple(g.shape)} "
                                     f"{g.dtype}")
        return 0.0
    if name == "group_scatter":
        err = 0.0
        for g, w_ in zip(got, want):      # points_bar, centroid_bar
            d = (g - w_).abs().max().item()
            if g.dtype != w_.dtype or d > SCATTER_TOL * w_.abs().max().item():
                raise AssertionError(f"group_scatter max abs err {d} at "
                                     f"{tuple(g.shape)}")
            err = max(err, d)
        return err
    if name == "interp_scatter":
        err = (got - want).abs().max().item()
        if got.dtype != want.dtype or err > SCATTER_TOL * want.abs().max():
            raise AssertionError(f"interp_scatter max abs err {err} at "
                                 f"{tuple(got.shape)}")
        return err
    if name == "ball_query_group":
        for g, w_ in zip(got, want):
            if g.dtype != w_.dtype or not torch.equal(g, w_):
                diff = (g.float() - w_.float()).abs().max().item()
                raise AssertionError(f"ball_query_group differs at "
                                     f"{tuple(g.shape)} {g.dtype}: max {diff}")
        return 0.0
    if name == "sa_fused":
        err = 0.0
        for g, w_ in zip(got, want):
            d = (g.float() - w_.float()).abs()
            scale = w_.float().abs().max().item()
            share = (d > 0).float().mean().item()
            print(f"[kernels]   sa_fused radius {tuple(g.shape)}: max abs err "
                  f"{d.max().item():.3g} (max |plain| {scale:.3g}), "
                  f"{share:.2%} of elements differ")
            if g.dtype != torch.bfloat16 or d.max() > SA_TOL * max(1.0, scale):
                raise AssertionError(f"sa_fused max abs err {d.max().item()} "
                                     f"(max |plain| {scale})")
            err = max(err, d.max().item())
        return err
    if got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.dtype} vs plain {want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if name == "fp_interpolate":
        ok = err <= (BF16_FP_TOL if bf16 else FP_REL_TOL) * scale
    else:
        ok = err <= (BF16_FOLD_TOL if bf16 else FOLD_TOL) * max(1.0, scale)
    if not ok:
        raise AssertionError(f"{name} max abs err {err} (max |plain| {scale}) "
                             f"at {tuple(got.shape)}")
    return err


def _unpacked(name: str, args):
    """The case with its weights as plain tensors, for the two kernels
    whose cases carry them packed."""
    if name == "fold_upsample":
        return args[0], args[1].k, args[1].b, args[1].epilogue
    if name == "sa_fused":
        from istnet_tpu_torch.ops.sa_fused import unpack_folded
        return (*args[:5], unpack_folded(args[5]))
    return None


def phase_kernels(cases, bf16: bool = False, tag: str = "") -> dict:
    """Each case through the kernel and its plain version; per kernel the
    worst error. ``cases``: name -> list of (args, on the path)."""
    import torch

    from istnet_tpu_torch.ops import dispatch
    tag = tag + "bf16 " if bf16 else tag
    errs = {}
    for name, case_list in cases.items():
        mod = dispatch.KERNELS[name]
        kern = dispatch.wrapper(name)
        worst = 0.0
        for args, _ in case_list:
            got, want = kern(*args), mod.plain(*args)
            torch.cuda.synchronize()
            weights = name == "three_nn" and args[2:] and args[2]
            err = _check(name + " weights" if weights else name, got, want,
                         bf16)
            if name in ("group_scatter", "interp_scatter"):
                # owned, ordered sums: a second launch gives the same bits
                again = kern(*args)
                for g, a in zip(*((got, again) if name == "group_scatter"
                                  else ([got], [again]))):
                    if not torch.equal(g, a):
                        raise AssertionError(f"{name}: a second launch "
                                             f"changes the bits")
            loose = _unpacked(name, args)
            if loose is not None:
                # packing on the fly, and a second launch: the same bits
                again = kern(*loose)
                for g, a in zip(*((got, again) if name == "sa_fused"
                                  else ([got], [again]))):
                    if not torch.equal(g, a):
                        raise AssertionError(f"{name}: unpacked weights or a "
                                             f"second launch change the bits")
            worst = max(worst, err)
            print(f"[kernels] {tag}{name} {_label(name, args)}: match, max abs "
                  f"err {err:.3g}")
        errs[name] = worst
    return errs


def phase_forward(model, device, per_forward: dict, tag: str = "",
                  points: int = 1024) -> dict:
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_inputs
    batches = [make_inputs(BATCH, points, seed=1 + i, device=device)
               for i in range(SERVED_BATCHES)]
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    outs = []
    with torch.inference_mode():
        t0 = time.perf_counter()
        for inp in batches:
            outs.append(model(inp))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    counts = ops.launch_counts()
    print(f"[forward] {tag}served {SERVED_BATCHES} batches of {BATCH} in "
          f"{seconds:.3f} s (first calls included); launches {counts}")
    for name, k in per_forward.items():
        if counts[name] != k * SERVED_BATCHES:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{k * SERVED_BATCHES}")
    eye = torch.eye(3, device=device)
    for out in outs:
        shapes = {k: tuple(v.shape) for k, v in out.items()}
        if shapes != {"pred_qo": (BATCH, points, 3),
                      "pred_rotation": (BATCH, 3, 3),
                      "pred_translation": (BATCH, 3),
                      "pred_size": (BATCH, 3)}:
            raise AssertionError(f"output shapes {shapes}")
        for k, v in out.items():
            if v.dtype != torch.float32 or not torch.isfinite(v).all():
                raise AssertionError(f"{k} is not finite float32 ({v.dtype})")
        r = out["pred_rotation"]
        orth = (r.transpose(1, 2) @ r - eye).abs().max().item()
        if orth > 1e-5:
            raise AssertionError(f"R^T R - I = {orth}")
    print(f"[forward] {tag}outputs finite float32, shapes right, "
          f"max |R^T R - I| <= 1e-5")
    return counts


def phase_reference(model, device, atol: float = CPU_ATOL,
                    tag: str = "", points: int = 1024) -> None:
    import torch

    from istnet_tpu_torch.entry import build_model, make_inputs
    cpu = build_model("cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    inp = make_inputs(2, points, seed=7, device="cpu")
    with torch.inference_mode():
        want = cpu(inp)
        got = model({k: v.to(device) for k, v in inp.items()})
    worst = 0.0
    for k, w in want.items():
        err = (got[k].cpu() - w).abs().max().item()
        print(f"[reference] {tag}B=2 {k}: card vs CPU max abs err {err:.3g}")
        worst = max(worst, err)
    if worst > atol:
        raise AssertionError(f"card vs CPU forward differ by {worst} > {atol}")


def phase_drift(model, device) -> None:
    """The bf16 forward against the float32 one, same weights and inputs,
    both on the card."""
    import torch

    from istnet_tpu_torch.entry import make_inputs
    inp = make_inputs(BATCH, seed=1, device=device)
    with torch.inference_mode():
        with policy(torch.float32):
            f32 = model(inp)
        b16 = model(inp)
    for k, v in f32.items():
        print(f"[reference] bf16 vs f32 B={BATCH} {k}: max abs drift "
              f"{(b16[k] - v).abs().max().item():.3g} (max |f32| "
              f"{v.abs().max().item():.3g})")


def phase_timings(model, cases, device, tag: str = "") -> dict:
    """The B=32 forward and its sections, then every kernel case against
    its plain version; per kernel the summed ms of the cases on the path."""
    import torch

    from istnet_tpu_torch.entry import make_inputs
    from istnet_tpu_torch.ops import dispatch
    inp = make_inputs(BATCH, seed=1, device=device)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model(inp), iters=10)
    print(f"[timings] {tag}B={BATCH} forward {fwd:.3f} ms "
          f"({BATCH / fwd * 1e3:.1f} inf/s)")
    # the forward's sections, each timed alone on the same inputs
    with torch.inference_mode():
        pts = inp["pts"] - inp["pts"].mean(dim=1, keepdim=True)
        cls = inp["category_label"]
        enc = model.rgb_cam_extractor
        rgb_local = enc.sparse_points(inp["rgb"], inp["choose"])
        pts_local = model.pts_cam_extractor(pts)

        def heads():
            pts_w, pts_w_local = model.implicit_transform(rgb_local, pts_local,
                                                          pts, cls)
            return model.main_estimator(pts, pts_w, rgb_local, pts_local,
                                        pts_w_local)

        sections = {
            "rgb encoder (trunk+PSP+up_1+up_2+sparse head)":
                lambda: enc.sparse_points(inp["rgb"], inp["choose"]),
            "  trunk": lambda: enc.model.feats(inp["rgb"]),
            "PointNet2MSG (4 SA + 4 FP)": lambda: model.pts_cam_extractor(pts),
            "implicit transform + pose heads": heads,
        }
        for label, fn in sections.items():
            print(f"[timings] {tag}section {label}: "
                  f"{cuda_ms(fn, iters=10):.3f} ms")
    return time_kernels(cases, tag)


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for item in x:
            yield from _tensors(item)
    elif dataclasses.is_dataclass(x):
        # packed weights: what they were made from, not the layout derived
        # from it (PackedFold.km beside k)
        for field in dataclasses.fields(x):
            if field.name != "km":
                yield from _tensors(getattr(x, field.name))


def bound_ms(name: str, args, out) -> tuple[float, float]:
    """The least ms the card could take for one call: (bytes, operations).
    Bytes: every input tensor read once and every output written once over
    the device memory rate. Operations: what the function needs on these
    shapes over the peak rate of their type (float32 outside the tensor
    cores; bf16 tensor cores for the bf16 matrix products of the fused SA
    stage and the fold): ~10 a point pair for an FPS distance update, ~8 for
    a ball-query or 3-NN distance test, 2 a multiply-add of an MLP or a
    convolution (the fused SA stage, reassociated: layer 1 once per point
    and radius, its three xyz rows in float32 for the points and for the
    centroids, layers 2..L once per slot row; the fold, reassociated: the channel contraction once per
    low-resolution pixel and each of the 9 taps; the interpolation after it
    is left out), ~6 a channel for a 3-point interpolation, 1 an added
    element for the scatters; none for the eval BN pass (~8 an element,
    far below its bytes). Depth fill, the least the function needs on
    this input: ~36 a pixel for the windows every pixel passes (the three
    band crosses as separable running maxima ~20, the 5 x 5 closing as
    separable max and min ~16), and ~442 a pixel that is valid in the input
    for the two medians and the bilateral, which run only where the map is
    valid (a median of 25 with the column sorts shared between neighbours:
    9 + 82 = 91 compare-exchanges at 2 each; 13 bilateral taps at ~6). The
    dilations only widen the valid set, so the input's count is a floor of
    the medians'; the 9 x 9 and the six 5 x 5 dilations into empty pixels
    are left out. So the bound is a lower one."""
    import torch
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(_tensors(args)) + list(_tensors(out)))
    f32 = 0.0     # operations at the float32 rate
    mma = 0.0     # operations at the bf16 tensor-core rate
    if name == "fps":
        b, n, _ = args[0].shape
        f32 = 10.0 * b * n * args[1]
    elif name in ("ball_query_group", "ball_query", "sa_fused"):
        xyz, new_xyz = args[2], args[3]
        b, n, m = xyz.shape[0], xyz.shape[1], new_xyz.shape[1]
        f32 = 8.0 * b * n * m
        if name == "sa_fused":
            # layer 1 once a point (U) and once a centroid, not once a slot
            for ns, ch in zip(args[1], args[5].chans):
                mma += 2.0 * b * n * (ch[0] - 3) * ch[1]
                f32 += 2.0 * 3 * b * (n + m) * ch[1]
                mma += sum(2.0 * ci * co for ci, co in zip(ch[1:-1], ch[2:])) \
                    * b * m * ns
    elif name in ("fp_interpolate", "three_nn"):
        unknown, known = args[0], args[1]
        b, n, m = unknown.shape[0], unknown.shape[1], known.shape[1]
        f32 = 8.0 * b * n * m
        if name == "fp_interpolate":
            f32 += 6.0 * b * n * args[2].shape[-1]
    elif name == "fold_upsample":
        b, h, w, cin = args[0].shape
        ops = 2.0 * 9 * b * h * w * cin * args[1].k.shape[-1]
        if args[0].dtype == torch.bfloat16:
            mma = ops
        else:
            f32 = ops
    elif name == "group_scatter":
        f32 = float(sum(g.numel() for g in args[1]))
    elif name == "interp_scatter":
        f32 = 6.0 * args[0].numel()
    elif name == "depth_fill":
        f32 = (36.0 * args[0].numel()
               + 442.0 * float((args[0] > 0.01).sum().item()))
    elif name != "bn_eval":       # the eval BN pass: its bytes alone
        raise KeyError(name)
    return nbytes / HBM_BPS * 1e3, (f32 / F32_OPS + mma / BF16_OPS) * 1e3


# the PyTorch call of ``library_call``, by kernel
LIBRARY_CALLS = {"group_scatter": "index_add_", "interp_scatter": "index_add_",
                 "bn_eval": "F.batch_norm"}


def library_call(name: str, args):
    """One PyTorch call that computes the kernel's sum on the same inputs,
    as a yardstick the port never calls, or None where there is none: each
    other kernel fuses a search, a gather, a product or a stencil chain with
    what follows it. The scatters: ``index_add_`` of the same rows into the
    same rows, per radius for the grouping scatter (its centroid sums left
    out) and on the weighted rows, formed ahead, for the interpolation's;
    bf16 cotangents are widened to float32 ahead (``index_add_`` adds rows
    of the output's dtype). The eval BN pass: ``F.batch_norm`` at eval of
    the map's memory as (rows, C), the BN alone (its consumer left out;
    invstd handed over as the variance, which costs the same)."""
    import torch
    if name == "bn_eval":
        x, rows = args[:2]
        c = x.shape[-1]
        flat = torch.as_strided(x, (x.numel() // c, c), (c, 1))
        mean, invstd, weight, bias = rows.unbind(0)
        return lambda: torch.nn.functional.batch_norm(
            flat, mean, invstd, weight, bias, False, 0.0, 1e-5)
    if name == "group_scatter":
        idx_list, grads, n = args
        b, c = grads[0].shape[0], grads[0].shape[-1]
        base = torch.arange(b, device=grads[0].device)[:, None, None] * n
        flat = [(i.long() + base).reshape(-1) for i in idx_list]
        rows = [g.float().reshape(-1, c) for g in grads]
        out = torch.zeros(b * n, c, device=grads[0].device)

        def call():
            out.zero_()
            for f, r in zip(flat, rows):
                out.index_add_(0, f, r)
        return call
    if name == "interp_scatter":
        grad, idx, weight, m = args
        b, n, c = grad.shape
        base = torch.arange(b, device=grad.device)[:, None, None] * m
        flat = (idx.long() + base).reshape(-1)
        rows = (weight[..., None] * grad.float()[:, :, None, :]).reshape(-1, c)
        out = torch.zeros(b * m, c, device=grad.device)
        return lambda: out.zero_().index_add_(0, flat, rows)
    return None


def _launch_name(name: str) -> str:
    """A device event's kernel name without its namespace, template
    arguments and parameters; the event's own name where it has none (a
    memset)."""
    m = re.search(r"(\w+)(?:<[^()]*>)?\(", name)
    return m.group(1) if m else name


def launch_us(fn, iters: int = 10) -> list:
    """Device microseconds of each launch of one call of ``fn``, in launch
    order: ``[(kernel name, us)]``, each launch's median over ``iters``
    calls of torch.profiler's device events (kernels and memsets). The
    trace holds ``iters + 1`` calls, the first there to be lost (as in
    ``device_us``); ``[]`` where the events left do not line up call by
    call."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters + 1):
            fn()
        torch.cuda.synchronize()
    events = sorted((e.time_range.start, _launch_name(e.name),
                     e.time_range.end - e.time_range.start)
                    for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    per_call = round(len(events) / (iters + 1))
    events = events[len(events) - per_call * iters:]
    if per_call == 0 or len(events) < per_call * iters:
        return []
    out = []
    for k in range(per_call):
        names = {name for _, name, _ in events[k::per_call]}
        if len(names) != 1:
            return []
        out.append((names.pop(), statistics.median(
            us for _, _, us in events[k::per_call])))
    return out


def gather_yardstick(args):
    """``torch.index_select`` of the rows a grouping case copies, with the
    indices (the plain query's) given ahead: what a plain gather of these
    bytes costs on the card. It leaves out the query and the centroid
    subtraction, so it is no library call of the same function and never
    goes into ``library_ms``; the port never calls it."""
    import torch

    from istnet_tpu_torch.ops import pointnet2 as plain
    radii, nsamples, xyz, new_xyz, feats = args[:5]
    out_dtype = args[5] if len(args) > 5 else torch.float32
    b, n, _ = xyz.shape
    rows = xyz if feats is None else torch.cat([xyz, feats.float()], dim=-1)
    table = rows.to(out_dtype).reshape(b * n, -1)
    base = torch.arange(b, device=xyz.device)[:, None, None] * n
    flat = [(i.long() + base).reshape(-1)
            for i in plain.ball_query_multi(radii, nsamples, xyz, new_xyz)]
    return lambda: [torch.index_select(table, 0, f) for f in flat]


def three_nn_yardstick(args):
    """``torch.cdist`` of the unknown to the known points and the 3
    smallest of each row by ``topk``: a library search of the same
    neighbours by another formula (direct differences, not the JAX form
    whose rounding the kernel repeats, and no tie order), so it is no
    library call of the same function and never goes into ``library_ms``;
    the port never calls it."""
    import torch
    unknown, known = args[:2]
    return lambda: torch.cdist(unknown, known).topk(3, largest=False)


def _device_total(fn) -> float:
    """Device us of one call summed over its kernels, NaN where the trace
    held none of them."""
    return sum(device_us(fn).values()) or float("nan")


def _stage_split(name: str, kern, args, tag: str) -> dict:
    """Device time of the kernels read part by part (by events a call of
    these wrappers can cost more host time than card time): the fused SA
    kernel (U, then the main kernel) and the fold (GEMM, then
    interpolation) stage by stage; FPS as ns a step; the grouping beside
    kernel 8 (the query alone, its lists stored as indices) and the
    ``index_select`` yardstick; the scatters by launch (the inversion, then
    the gather) beside ``index_add_`` of the same rows; kernels 3, 8 and 10
    a call by FP or SA stage, kernel 10 beside the ``cdist`` + ``topk``
    yardstick; kernel 11 launch by launch (``launch_us``). Returns the
    device us read."""
    from istnet_tpu_torch.ops import dispatch
    if name in ("group_scatter", "interp_scatter"):
        sums = device_us(lambda: kern(*args))
        inv = sum(v for k, v in sums.items() if "invert" in k)
        us = sum(sums.values()) or float("nan")
        lib = _device_total(library_call(name, args))
        parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(sums.items()))
        print(f"[timings] {tag}{name} {_label(name, args)}: device {us:.1f} "
              f"us a call ({parts or 'no device event'}); index_add_ "
              f"{lib:.1f} us")
        return {"device": us, "inversion": inv, "index_add_": lib}
    if name in ("sa_fused", "fold_upsample"):
        sums = device_us(lambda: kern(*args))
        parts = ", ".join(f"{k} {v:.1f}" for k, v in sorted(sums.items()))
        print(f"[timings] {tag}{name} {_label(name, args)} device us a call "
              f"by stage: {parts or 'not measured (no device event)'}")
        return {}
    if name == "depth_fill":
        launches = launch_us(lambda: kern(*args))
        us = sum(t for _, t in launches) or float("nan")
        parts = ", ".join(f"{k} {t:.1f}" for k, t in launches)
        print(f"[timings] {tag}depth_fill {_label(name, args)}: device "
              f"{us:.1f} us a call by launch: "
              f"{parts or 'not measured (events lost)'}")
        return {"device": us}
    if name == "fps":
        us = _device_total(lambda: kern(*args))
        print(f"[timings] {tag}fps {_label(name, args)}: device {us:.1f} us a "
              f"call, {us * 1e3 / max(1, args[1] - 1):.0f} ns a step")
        return {"device": us}
    if name == "ball_query_group":
        query = dispatch.wrapper("ball_query")
        us = _device_total(lambda: kern(*args))
        q_us = _device_total(lambda: query(*args[:4]))
        y_us = _device_total(gather_yardstick(args))
        print(f"[timings] {tag}ball_query_group {_label(name, args)}: device "
              f"{us:.1f} us a call; kernel 8's query of the same lists "
              f"{q_us:.1f} us; index_select of the same rows {y_us:.1f} us "
              f"(yardstick)")
        return {"device": us, "query": q_us, "index_select": y_us}
    if name in ("fp_interpolate", "ball_query", "three_nn"):
        us = _device_total(lambda: kern(*args))
        out = {"device": us}
        note = ""
        if name == "three_nn":
            out["cdist_topk"] = _device_total(three_nn_yardstick(args))
            note = (f"; cdist + topk of the same points "
                    f"{out['cdist_topk']:.1f} us (yardstick)")
        print(f"[timings] {tag}{name} {_label(name, args)}: device {us:.1f} "
              f"us a call{note}")
        return out
    return {}


def time_kernels(cases, tag: str = "") -> dict:
    """Every kernel case against its plain version; per kernel the ms of
    one forward (or train step): each case's time times its count there
    (``on_path``: True/False for once/never, or a launch count), the
    bound of the same calls with what sets it, and the library call's ms
    where there is one."""
    from istnet_tpu_torch.ops import dispatch
    times = {}
    for name, case_list in cases.items():
        mod = dispatch.KERNELS[name]
        kern = dispatch.wrapper(name)
        k_ms = p_ms = l_ms = bytes_ms = ops_ms = least = 0.0
        lib = None
        split: dict = {}
        for args, on_path in case_list:
            km = cuda_ms(lambda: kern(*args), iters=20)
            pm = cuda_ms(lambda: mod.plain(*args), iters=3, warmup=1)
            lib = library_call(name, args)
            lm = None if lib is None else cuda_ms(lib, iters=20)
            by, op = bound_ms(name, args, kern(*args))
            note = ("" if on_path is True else " (off the path)"
                    if not on_path else f" (x{on_path} a step)")
            lib_note = ("" if lm is None
                        else f", {LIBRARY_CALLS[name]} {lm:.4f} ms")
            print(f"[timings] {tag}{name} {_label(name, args)}: kernel "
                  f"{km:.4f} ms, plain {pm:.4f} ms{lib_note}, bound "
                  f"{max(by, op):.5f} ms (bytes {by:.5f}, operations "
                  f"{op:.5f}){note}")
            for k, v in _stage_split(name, kern, args, tag).items():
                if on_path:
                    split[k] = split.get(k, 0.0) + v * on_path
            k_ms += km * on_path
            p_ms += pm * on_path
            l_ms += (lm or 0.0) * on_path
            bytes_ms += by * on_path
            ops_ms += op * on_path
            least += max(by, op) * on_path
        if split:
            print(f"[timings] {tag}{name} device us a pass of the path: "
                  + ", ".join(f"{k} {v:.1f}" for k, v in split.items()))
        times[name] = (k_ms, p_ms, least,
                       "bytes" if bytes_ms >= ops_ms else "operations",
                       l_ms if lib is not None else None)
    return times


def phase_stage1_choice(model, device) -> None:
    """SA stage 1 under bf16, fused kernel against the unfused stage the
    model runs (bf16 grouping + SharedMLP + max), same weights and inputs:
    the choice the JAX package measured on its own chip
    (``istnet_tpu/ops/dispatch.py:141-148``)."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_inputs
    from istnet_tpu_torch.nn.pointnet2_msg import _fold_shared_mlp
    sa = model.pts_cam_extractor.SA_modules[0]
    inp = make_inputs(BATCH, seed=1, device=device)
    with torch.inference_mode():
        xyz = inp["pts"] - inp["pts"].mean(dim=1, keepdim=True)
        new_xyz = ops.gather_points(xyz, ops.furthest_point_sample(xyz,
                                                                  sa.npoint))
        folded = [_fold_shared_mlp(mlp) for mlp in sa.mlps]

        def unfused():
            grouped = ops.ball_query_group(sa.radii, sa.nsamples, xyz, new_xyz,
                                           None, torch.bfloat16)
            return torch.cat([mlp(g).amax(dim=2)
                              for g, mlp in zip(grouped, sa.mlps)], dim=-1)

        def fused():
            return torch.cat(ops.sa_msg_fused(sa.radii, sa.nsamples, xyz,
                                              new_xyz, None, folded), dim=-1)

        a, b = unfused().float(), fused().float()
        err = (a - b).abs().max().item()
        scale = a.abs().max().item()
        # BN folded into bf16 weights vs BN after a bf16 matmul: the JAX
        # module test's bound (tests/test_sa_fused.py:186-188)
        if err > 5e-2 * max(1.0, scale):
            raise AssertionError(f"stage 1 fused vs unfused: {err}")
        u_ms, f_ms = cuda_ms(unfused, iters=20), cuda_ms(fused, iters=20)
    print(f"[timings] bf16 SA stage 1 (B={BATCH}, N=1024, M=512): unfused "
          f"(grouping + SharedMLP + max) {u_ms:.4f} ms, fused kernel "
          f"{f_ms:.4f} ms; outputs agree to {err:.3g} (max {scale:.3g})")


def _dropout_off(model) -> None:
    from istnet_tpu_torch.nn.layers import Dropout2d
    for m in model.modules():
        if isinstance(m, Dropout2d):
            m.eval()


def _check_step(model, opt, cfg, step, parts, before, stats, tag) -> None:
    """One train step's invariants: finite loss parts and gradients, the
    trained parameters moved (each with a gradient above rounding), the
    frozen ones did not, and every BatchNorm that ran took the scheduled
    EMA of its published batch statistics."""
    import torch

    from istnet_tpu_torch.train.train_state import batch_norms
    bad = [k for k, v in parts.items() if not torch.isfinite(v)]
    if bad:
        raise AssertionError(f"{tag}: loss parts {bad} not finite")
    trained = {id(p) for g in opt.param_groups for p in g["params"]}
    no_grad, still = [], []
    for name, p in model.named_parameters():
        moved = not torch.equal(p.detach(), before[name])
        if id(p) not in trained:
            if moved:
                raise AssertionError(f"{tag}: frozen {name} moved")
            continue
        if p.grad is None:
            no_grad.append(name)
            continue
        if not torch.isfinite(p.grad).all():
            raise AssertionError(f"{tag}: gradient of {name} not finite")
        if not moved and p.grad.abs().max() > 1e-6:
            still.append(name)
    # the trunk's classifier is loaded and never run (resnet_psp.py)
    no_grad = [n for n in no_grad if ".feats.fc." not in n]
    if no_grad or still:
        raise AssertionError(f"{tag}: no gradient {no_grad}; did not move "
                             f"{still}")
    m = cfg.momentum(step)
    ran = 0
    for bn, (mean, var, count) in zip(batch_norms(model), stats):
        if bn.batch_mean is None:
            if not torch.equal(bn.running_mean, mean):
                raise AssertionError(f"{tag}: an idle BatchNorm moved")
            continue
        ran += 1
        for got, old, batch in ((bn.running_mean, mean, bn.batch_mean),
                                (bn.running_var, var, bn.batch_var)):
            want = (1.0 - m) * old + m * batch
            if torch.equal(got, old) or not torch.allclose(got, want,
                                                           rtol=1e-6,
                                                           atol=1e-7):
                raise AssertionError(f"{tag}: BatchNorm statistics off the "
                                     f"EMA with momentum {m}")
        if int(bn.num_batches_tracked) != int(count) + 1:
            raise AssertionError(f"{tag}: num_batches_tracked")
    print(f"[train] {tag}: loss {float(parts['total']):.6g} "
          f"({', '.join(f'{k} {float(v):.4g}' for k, v in parts.items())}); "
          f"{len(trained)} trained tensors finite and moved; {ran} "
          f"BatchNorms took the EMA (momentum {m:.4g})")


def phase_bf16_backward(device) -> None:
    """The two autograd Functions with bf16 cotangents at the train step's
    shapes (the bf16 train policy's; the float32 step sends none): the FP
    interpolation of bf16 features, and the grouping of bf16 features into
    bf16 outputs at SA 2-4, each against autograd through its plain op on
    the card, on the same inputs and cotangents. Bounds: float32
    gradients (points, centroids) FP_REL_TOL of the largest, as the
    scatters (float32 sums of exact bf16 values in another order); the
    bf16 features' gradients BF16_GRAD_TOL through the FP stages (both
    round a float32 sum once: one bf16 ulp apart at most) and twice that
    through the grouping (the plain op rounds each radius's sum to bf16 and
    their sum again: two ulps)."""
    import numpy as np
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.ops import pointnet2 as plain
    bf16 = torch.bfloat16
    rng = np.random.RandomState(8)
    cases = train_kernel_cases(device)
    for args, _ in cases["fp_interpolate"]:
        unknown, known, feats = args
        cot = _f32(rng.randn(*unknown.shape[:2], feats.shape[-1]),
                   device).to(bf16)

        def fp_grads(op):
            f = feats.to(bf16).requires_grad_()
            op(unknown, known, f).backward(cot)
            return [f.grad]

        _check_grads("fp_interpolate", _label("fp_interpolate", args),
                     fp_grads(ops.fp_interpolate),
                     fp_grads(plain.fp_interpolate), [BF16_GRAD_TOL])
    for args, _ in cases["ball_query_group"]:
        radii, nsamples, xyz, new_xyz, feats = args
        if feats is None:
            continue
        b, m = new_xyz.shape[:2]
        cots = [_f32(rng.randn(b, m, ns, 3 + feats.shape[-1]),
                     device).to(bf16) for ns in nsamples]

        def group_grads(op):
            ins = [xyz.clone().requires_grad_(),
                   new_xyz.clone().requires_grad_(),
                   feats.to(bf16).requires_grad_()]
            torch.autograd.backward(op(radii, nsamples, *ins, bf16), cots)
            return [t.grad for t in ins]

        _check_grads("ball_query_group", _label("ball_query_group", args),
                     group_grads(ops.ball_query_group),
                     group_grads(plain.ball_query_group),
                     [FP_REL_TOL, FP_REL_TOL, 2 * BF16_GRAD_TOL])


def _check_grads(name, label, got, want, tols) -> None:
    """Gradients of one case, each in its plain op's dtype and within its
    bound times the largest plain value."""
    errs = []
    for g, w, tol in zip(got, want, tols):
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        if g.dtype != w.dtype or not err <= tol * scale:
            raise AssertionError(f"bf16 backward {name} {label}: {g.dtype} "
                                 f"vs {w.dtype}, max abs err {err} (max "
                                 f"|plain| {scale}, bound {tol:g})")
        errs.append(f"{_dtype(g)} {err:.3g} (max {scale:.3g})")
    print(f"[train-bf16-backward] {name} {label}: gradients match, max abs "
          f"err " + ", ".join(errs))


def phase_train_steps(device, dtype=None, points: int = TRAIN_POINTS,
                      recipes=("default", "frozen"), tag: str = "") -> dict:
    """TRAIN_STEPS default-recipe and FROZEN_STEPS frozen-recipe steps at
    the training width under the compute policy ``dtype`` (float32 if
    None), clouds of ``points``; returns the launches of all the steps."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        batch_norms,
        make_optimizer,
        train_step,
    )
    dtype = dtype or torch.float32
    totals: dict = {}
    torch.cuda.reset_peak_memory_stats(device)
    plan = {"default": (TrainConfig(), TRAIN_STEPS, TRAIN_PER_STEP),
            "frozen": (TrainConfig.frozen(), FROZEN_STEPS, FROZEN_PER_STEP)}
    for recipe in recipes:
        cfg, steps, per_step = plan[recipe]
        model = build_train_model(device, seed=0,
                                  freeze_world_enhancer=cfg.freeze_world_enhancer,
                                  sa_npoints=TRAIN_SA_NPOINTS, dtype=dtype)
        opt = make_optimizer(model, cfg)
        gen = torch.Generator(device=device).manual_seed(0)
        for step in range(steps):
            batch = make_train_batch(TRAIN_BATCH, points, TRAIN_IMG,
                                     seed=10 + step, device=device)
            before = {k: p.detach().clone()
                      for k, p in model.named_parameters()}
            stats = [(bn.running_mean.clone(), bn.running_var.clone(),
                      bn.num_batches_tracked.clone())
                     for bn in batch_norms(model)]
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            parts = train_step(model, opt, batch, step, gen, cfg)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = ops.launch_counts()
            label = (f"{tag}{recipe} step {step} (B={TRAIN_BATCH}, "
                     f"N={points}, {seconds:.3f} s)")
            if counts != per_step:
                raise AssertionError(f"{label}: launches {counts}, expected "
                                     f"{per_step}")
            _check_step(model, opt, cfg, step, parts, before, stats, label)
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        print(f"[train] {tag}{recipe}: launches per step as expected "
              f"{per_step}")
        del model, opt
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[train] {tag}peak memory allocated {peak:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return totals


def phase_train_reference(device) -> None:
    """One default-recipe step on the card against the same step of the
    port's CPU path: same weights, batch and LR, dropout off."""
    import torch

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        make_optimizer,
        train_step,
    )
    cfg = TrainConfig()
    batch = make_train_batch(REF_BATCH, REF_POINTS, REF_IMG, seed=5,
                             device="cpu")
    batch["inputs"]["pts"] = batch["inputs"]["pts"] * 0.3
    init = None
    runs = []
    for dev in ("cpu", device):
        model = build_train_model(dev, seed=3, sa_npoints=REF_SA_NPOINTS)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        _dropout_off(model)
        b = {part: {k: v.to(dev) for k, v in d.items()}
             for part, d in batch.items()}
        parts = train_step(model, make_optimizer(model, cfg), b, 0,
                           torch.Generator(device=dev), cfg)
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()
                 if p.grad is not None}
        state = {k: v.cpu() for k, v in model.state_dict().items()}
        runs.append(({k: float(v) for k, v in parts.items()}, grads, state))
    (l_cpu, g_cpu, s_cpu), (l_gpu, g_gpu, s_gpu) = runs
    loss_err = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12)
                   for k, v in l_cpu.items())
    if set(g_cpu) != set(g_gpu):
        raise AssertionError("card and CPU differ in which parameters have "
                             "a gradient")
    g_err = {k: (g_gpu[k] - g).abs().max().item()
             / max(g.abs().max().item(), 1e-30) for k, g in g_cpu.items()}
    g_top = max(g.abs().max().item() for g in g_cpu.values())
    g_all = (max((g_gpu[k] - g).abs().max().item() for k, g in g_cpu.items())
             / g_top)
    above = {k: e for k, e in g_err.items()
             if g_cpu[k].abs().max().item() > REF_GRAD_FLOOR * g_top}
    lr = cfg.lr(0)
    u_off, s_err = [], {}
    for k, v in s_cpu.items():
        if k.endswith("num_batches_tracked"):
            continue
        d = (s_gpu[k] - v).abs()
        if "running" in k:
            s_err[k] = d.max().item() / max(v.abs().max().item(), 1e-30)
        else:
            u_off.append(d.flatten() / lr)
    u_off = torch.cat(u_off)
    u_max, u_share = u_off.max().item(), (u_off > 0.1).float().mean().item()

    def worst(errs, n=5):
        return ", ".join(
            f"{k} {e:.3g} (max|g| {g_cpu[k].abs().max().item():.3g}, "
            f"{g_cpu[k].numel()} el.)"
            for k, e in sorted(errs.items(), key=lambda kv: -kv[1])[:n])

    print(f"[train-reference] B={REF_BATCH} N={REF_POINTS} {REF_IMG}x"
          f"{REF_IMG}: loss parts rel err {loss_err:.3g}; gradients "
          f"normwise over all {g_all:.3g} (max|g| {g_top:.3g}), per tensor "
          f"median {sorted(g_err.values())[len(g_err) // 2]:.3g}, worst "
          + worst(g_err))
    print(f"[train-reference]   {len(above)} of {len(g_err)} tensors with "
          f"max|g| > {REF_GRAD_FLOOR:g} of the largest: worst "
          f"{worst(above, 3)}")
    worst_s = max(s_err, key=s_err.get)
    worst_t = max(above, key=above.get)
    print(f"[train-reference] updated parameters: {u_share:.3%} of "
          f"{u_off.numel()} elements off by more than 0.1 lr, the most "
          f"{u_max:.3g} lr; running statistics normwise <= "
          f"{s_err[worst_s]:.3g} ({worst_s})")
    if (loss_err > REF_LOSS_TOL or g_all > REF_GRAD_TOL
            or above[worst_t] > REF_GRAD_TENSOR_TOL
            or u_share > REF_UPDATE_SHARE
            or s_err[worst_s] > REF_STATS_TOL):
        raise AssertionError(
            f"card vs CPU train step: loss {loss_err} (tol {REF_LOSS_TOL}), "
            f"gradients {g_all} ({REF_GRAD_TOL}), per tensor {above[worst_t]} "
            f"at {worst_t} ({REF_GRAD_TENSOR_TOL}), updates off {u_share} "
            f"({REF_UPDATE_SHARE}), statistics {s_err[worst_s]} "
            f"({REF_STATS_TOL})")


def phase_train_full_width(device, dtype=None) -> None:
    """One default-recipe step at full width on the card under the policy
    ``dtype`` (float32 if None; bf16, the 2048-point config's) against the
    same step of the port's CPU path in float64, same weights and batch,
    dropout off: the loss parts and the gradients, within the policy's
    bounds. Then the card step once more from the same state: whether it
    repeats bit for bit."""
    import statistics

    import torch

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        make_optimizer,
        train_step,
    )
    dtype = dtype or torch.float32
    name = "float32" if dtype == torch.float32 else "bf16"
    loss_tol, grad_tol, tensor_tol = (
        (FULL_LOSS_TOL, FULL_GRAD_TOL, FULL_GRAD_TENSOR_TOL)
        if dtype == torch.float32 else
        (BF16_FULL_LOSS_TOL, BF16_FULL_GRAD_TOL, BF16_FULL_GRAD_TENSOR_TOL))
    cfg = TrainConfig()
    batch = make_train_batch(FULL_REF_BATCH, TRAIN_POINTS, TRAIN_IMG, seed=6,
                             device="cpu")
    init = None
    runs = []
    t0 = time.perf_counter()
    for dev, run_dtype in (("cpu", torch.float64), (device, dtype),
                           (device, dtype)):
        model = build_train_model(dev, seed=4, sa_npoints=TRAIN_SA_NPOINTS)
        if init is None:
            init = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(init)
        # the parameters stay float32 under bf16
        param_dtype = torch.float64 if dev == "cpu" else torch.float32
        model.to(param_dtype)
        _dropout_off(model)
        b = {part: {k: (v.to(param_dtype) if v.is_floating_point() else v
                        ).to(dev) for k, v in d.items()}
             for part, d in batch.items()}
        with policy(run_dtype):
            parts = train_step(model, make_optimizer(model, cfg), b, 0,
                               torch.Generator(device=dev), cfg)
        runs.append(({k: float(v) for k, v in parts.items()},
                     {k: p.grad.detach().double().cpu()
                      for k, p in model.named_parameters()
                      if p.grad is not None}))
        del model
    seconds = time.perf_counter() - t0
    (l_cpu, g_cpu), (l_gpu, g_gpu), (l_again, g_again) = runs
    if set(g_cpu) != set(g_gpu):
        raise AssertionError("full width: card and CPU differ in which "
                             "parameters have a gradient")
    loss_err = max(abs(l_gpu[k] - v) / max(abs(v), 1e-12)
                   for k, v in l_cpu.items())
    g_top = max(g.abs().max().item() for g in g_cpu.values())
    g_all = max((g_gpu[k] - g).abs().max().item()
                for k, g in g_cpu.items()) / g_top
    above = {k: (g_gpu[k] - g).abs().max().item() / g.abs().max().item()
             for k, g in g_cpu.items()
             if g.abs().max().item() > REF_GRAD_FLOOR * g_top}
    worst = sorted(above.items(), key=lambda kv: -kv[1])[:3]
    # float32: the worst tensor; bf16: the median tensor (a tensor whose
    # largest gradient is rounding noise drifts by O(1) under bf16)
    per_tensor = (worst[0][1] if dtype == torch.float32
                  else statistics.median(above.values()))
    differ = [k for k in g_gpu if not torch.equal(g_gpu[k], g_again[k])]
    by_module: dict = {}
    for k in differ:
        by_module[k.split(".")[0]] = by_module.get(k.split(".")[0], 0) + 1
    same_loss = l_gpu == l_again
    print(f"[train-reference] full width B={FULL_REF_BATCH} N={TRAIN_POINTS} "
          f"{TRAIN_IMG}x{TRAIN_IMG}, card {name} vs CPU float64 "
          f"({seconds:.1f} s): loss parts rel err {loss_err:.3g} (bound "
          f"{loss_tol:g}); gradients normwise over all {g_all:.3g} "
          f"(bound {grad_tol:g}; max|g| {g_top:.3g}); per tensor, "
          f"{len(above)} of {len(g_cpu)} above {REF_GRAD_FLOOR:g} of the "
          f"largest, median {statistics.median(above.values()):.3g}, worst "
          + ", ".join(f"{k} {e:.3g}" for k, e in worst)
          + f" (bound {tensor_tol:g} on the "
          + ("worst)" if dtype == torch.float32 else "median)"))
    print(f"[train-reference] full width {name}, a second card step: loss parts "
          f"{'equal' if same_loss else 'differ'}, {len(differ)} of "
          f"{len(g_gpu)} gradient tensors differ in their bits"
          + (f", by module {by_module} (first: {', '.join(differ[:3])})"
             if differ else ""))
    if differ or not same_loss:
        raise AssertionError("full width: a second card step from the same "
                             "state does not repeat the first bit for bit")
    if (loss_err > loss_tol or g_all > grad_tol or per_tensor > tensor_tol):
        raise AssertionError(
            f"full width card {name} vs CPU float64 train step: loss "
            f"{loss_err} ({loss_tol}), gradients {g_all} ({grad_tol}), per "
            f"tensor {per_tensor} ({tensor_tol})")


def phase_train_timings(device, frozen: bool = False, dtype=None,
                        points: int = TRAIN_POINTS) -> float:
    """Median ms of ``train_step`` at the training width (the default
    recipe, or the frozen one; under the policy ``dtype``, float32 if None;
    clouds of ``points``), then the split of the same step into its parts
    (``start_step``, then timed by CUDA events: ``step_loss``, the
    backward, ``finish_step``), peak memory and the kernels' launches a
    step; returns the bare step's samples/s."""
    import statistics

    import torch

    from istnet_tpu_torch import ops

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        deterministic_cudnn,
        finish_step,
        make_optimizer,
        start_step,
        step_loss,
        train_step,
    )
    dtype = dtype or torch.float32
    cfg = TrainConfig.frozen() if frozen else TrainConfig()
    model = build_train_model(device, seed=1, sa_npoints=TRAIN_SA_NPOINTS,
                              freeze_world_enhancer=frozen, dtype=dtype)
    opt = make_optimizer(model, cfg)
    gen = torch.Generator(device=device).manual_seed(1)
    batch = make_train_batch(TRAIN_BATCH, points, TRAIN_IMG, seed=30,
                             device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for step in range(2):
        ops.reset_launch_counts()
        train_step(model, opt, batch, step, gen, cfg)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    torch.cuda.synchronize()
    step_ms, host_ms = [], []
    for step in range(2, 2 + TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with no_gc():
            t0 = time.perf_counter()
            ev[0].record()
            train_step(model, opt, batch, step, gen, cfg)
            ev[1].record()
            host_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
        step_ms.append(ev[0].elapsed_time(ev[1]))
    split = []
    for step in range(2 + TIMED_STEPS, 2 + 2 * TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        with no_gc(), deterministic_cudnn():
            start_step(model, opt, step, cfg)
            ev[0].record()
            total, _ = step_loss(model, batch, gen, cfg)
            ev[1].record()
            total.backward()
            ev[2].record()
            finish_step(model, opt, step, cfg)
            ev[3].record()
            torch.cuda.synchronize()
        split.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    med = statistics.median(step_ms)
    fwd, bwd, upd = (statistics.median(s[i] for s in split) for i in range(3))
    name = "f32" if dtype == torch.float32 else "bf16"
    print(f"[timings] train B={TRAIN_BATCH} N={points} {name} "
          f"{'frozen' if frozen else 'default'} step: median {med:.3f} ms "
          f"over {TIMED_STEPS} (min {min(step_ms):.3f}, max "
          f"{max(step_ms):.3f}; {TRAIN_BATCH / med * 1e3:.1f} samples/s); "
          f"split medians: forward + loss {fwd:.3f} ms, backward {bwd:.3f} "
          f"ms, Adam + BN EMA {upd:.3f} ms; peak memory {peak:.2f} GiB; "
          f"host time to enqueue a step (train_step's return, no sync) "
          f"median {statistics.median(host_ms):.3f} ms; kernel launches a "
          f"step {counts}")
    del model, opt
    return TRAIN_BATCH / med * 1e3


def _holey_depth(rng, b, h, w):
    """Metres with 35% holes, an empty band at the top and empty columns in
    the first image."""
    d = rng.uniform(0.3, 2.8, size=(b, h, w)).astype("float32")
    d[rng.rand(b, h, w) < 0.35] = 0.0
    d[:, : h // 5] = 0.0
    d[0, :, : w // 8] = 0.0
    return d


def phase_depth_fill(device) -> dict:
    """Kernel 11 against its plain version at every listed shape and against
    the OpenCV pipeline; returns its cases for the timing phase: the serving
    frame (the path's call), and off the path the 35%-hole frame and a
    batch of 24 of them."""
    import numpy as np
    import torch

    from istnet_tpu_torch.data import depth_utils
    from istnet_tpu_torch.data.device_preprocess import fill_missing
    from istnet_tpu_torch.entry import make_frame
    from istnet_tpu_torch.ops import depth_fill, dispatch
    rng = np.random.RandomState(4)
    h, w = FRAME_SHAPE
    kern = dispatch.wrapper("depth_fill")
    kept = {}
    for shape in ((1, h, w), (TRAIN_BATCH, h, w), (2, 37, 150), (3, 100, 333),
                  (1, 5, 5)):
        depth = torch.from_numpy(_holey_depth(rng, *shape)).to(device)
        if shape[1:] == (h, w):
            kept[shape[0]] = depth
        for bilateral in (False, True):
            got = kern(depth, 3.0, bilateral)
            want = depth_fill.plain(depth, 3.0, bilateral)
            torch.cuda.synchronize()
            if not bilateral and not torch.equal(got, want):
                raise AssertionError(
                    f"depth_fill {shape}: the max/min/median chain differs "
                    f"by {(got - want).abs().max().item()}")
            err = _check("depth_fill", got, want, False)
        filled = (got > 0.01).float().mean().item()
        print(f"[depth-fill] {shape}: chain without bilateral equal, with it "
              f"max abs err {err:.3g} m; {filled:.1%} of pixels valid after")
    zero = kern(torch.zeros(1, h, w, device=device))
    if zero.abs().max().item() != 0.0:
        raise AssertionError("depth_fill: an all-zero frame did not stay zero")
    frame_mm = make_frame(3, SERVE_INSTANCES, hole_share=0.3)["depth_raw"]
    want_mm = depth_utils.fill_missing(frame_mm, 1000.0, 1.0,
                                       prefer_native=False)
    got_mm = fill_missing(torch.from_numpy(frame_mm)[None].to(device))[0]
    err_mm = float(np.abs(got_mm.cpu().numpy() - want_mm).max())
    if err_mm > DEPTH_FILL_CV2_TOL_MM:
        raise AssertionError(f"depth_fill vs the OpenCV pipeline: {err_mm} mm")
    print(f"[depth-fill] all-zero frame stays zero; a {h}x{w} frame against "
          f"the OpenCV pipeline: max abs err {err_mm:.3g} mm")
    # the OpenCV host fill (the host data path's fill before the native
    # core of phase 37) beside kernel 11 on the same frame
    frame_m = torch.from_numpy(frame_mm)[None].to(device)
    host_ms = timed(lambda: depth_utils.fill_missing(
        frame_mm, 1000.0, 1.0, prefer_native=False), iters=5, warmup=1) * 1e3
    card_ms = cuda_ms(lambda: fill_missing(frame_m), iters=20)
    print(f"[depth-fill] the OpenCV host fill of one {h}x{w} frame: "
          f"{host_ms:.3f} ms on this host's CPU (os.cpu_count() "
          f"{os.cpu_count()}); kernel 11's fill of it {card_ms:.3f} ms by "
          f"CUDA events")
    # the call the serving path makes: phase 12's frame in metres (the time
    # depends on the share of holes: the dilations of the second half run
    # only on empty pixels, the medians and the bilateral only on valid ones)
    serve_m = (torch.from_numpy(_serve_frame(device)[1])[None] / 1000.0
               ).to(device)
    for label, d in (("the serving frame", serve_m),
                     ("the 35%-hole frame", kept[1])):
        print(f"[depth-fill] {label}: {(d <= 0.01).float().mean().item():.1%} "
              f"of pixels empty on the way in")
    return {"depth_fill": [((serve_m,), True), ((kept[1],), False),
                           ((kept[TRAIN_BATCH],), False)]}


def _serve_frame(device):
    """The frame of phase 12: 6 instances, the last with a 9-pixel mask,
    padded to the bucket of 8 with empty masks."""
    from istnet_tpu_torch.entry import make_frame
    from istnet_tpu_torch.eval.test_loop import _pad_chunk
    fr = make_frame(1, SERVE_INSTANCES, n_tiny=1)
    masks, bboxes, category = _pad_chunk(fr["masks"], fr["bboxes"],
                                         fr["category_label"], SERVE_BUCKET)
    return fr["rgb_full"], fr["depth_raw"], masks, bboxes, category


def phase_device_forward(dtype, device, per_forward: dict, tag: str = ""):
    """One raw frame through the serving entry at full width, with the
    launch counts of that one call; then the per-frame times of its parts."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
    from istnet_tpu_torch.data.device_preprocess import (
        fill_missing,
        preprocess_shared_image,
    )
    from istnet_tpu_torch.entry import build_device_forward
    model, fn = build_device_forward(dtype, device)
    frame = _serve_frame(device)
    gen = torch.Generator(device=device).manual_seed(0)
    fn(*frame, gen)                                   # first calls
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out, n_valid = fn(*frame, gen)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {**{name: 0 for name in counts}, **per_forward, "depth_fill": 1}
    if counts != want:
        raise AssertionError(f"device forward launches {counts}, expected "
                             f"{want}")
    n_valid = n_valid.cpu().tolist()
    if (n_valid[SERVE_INSTANCES:] != [0] * (SERVE_BUCKET - SERVE_INSTANCES)
            or n_valid[SERVE_INSTANCES - 1] != 9
            or min(n_valid[:SERVE_INSTANCES - 1]) <= 16):
        raise AssertionError(f"n_valid {n_valid}")
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes != {"pred_qo": (SERVE_BUCKET, 1024, 3),
                  "pred_rotation": (SERVE_BUCKET, 3, 3),
                  "pred_translation": (SERVE_BUCKET, 3),
                  "pred_size": (SERVE_BUCKET, 3)}:
        raise AssertionError(f"output shapes {shapes}")
    for k, v in out.items():
        if v.dtype != torch.float32 or not torch.isfinite(v).all():
            raise AssertionError(f"{k} is not finite float32 ({v.dtype})")
    r = out["pred_rotation"]
    orth = (r.transpose(1, 2) @ r
            - torch.eye(3, device=device)).abs().max().item()
    if orth > 1e-5:
        raise AssertionError(f"R^T R - I = {orth}")
    print(f"[device-forward] {tag}frame of {SERVE_INSTANCES} instances in a "
          f"bucket of {SERVE_BUCKET}: n_valid {n_valid}, outputs finite "
          f"float32, max |R^T R - I| {orth:.2g}; launches {counts}")

    # per-frame times: CUDA events, and the host clock around a synchronise
    rgb, depth, masks, bboxes, category = (torch.as_tensor(a).to(device)
                                           for a in frame)
    intr = torch.tensor(REAL_INTRINSICS, device=device)
    with torch.inference_mode():
        filled = fill_missing(depth[None].float())[0]
        fill = cuda_ms(lambda: fill_missing(depth[None].float()), iters=20)
        pre = cuda_ms(lambda: preprocess_shared_image(
            rgb, filled, masks, bboxes, intr, gen), iters=20)
        whole = cuda_ms(lambda: fn(*frame, gen), iters=10)
        with no_gc():
            t0 = time.perf_counter()
            for _ in range(10):
                fn(*frame, gen)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 100
    print(f"[timings] {tag}device forward a frame (bucket {SERVE_BUCKET}): "
          f"{whole:.3f} ms by events, {wall:.3f} ms on the host clock, host "
          f"arrays uploaded each call; of it depth fill with unit scaling "
          f"{fill:.3f} ms, crop + sample + back-project + resize "
          f"{pre:.3f} ms")
    return counts, model


def phase_device_reference(device) -> None:
    """The serving path at a small model, card against CPU, same uniforms."""
    import torch

    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
    from istnet_tpu_torch.data.device_preprocess import (
        fill_missing,
        preprocess_shared_image,
    )
    from istnet_tpu_torch.entry import build_device_forward
    frame = _serve_frame(device)
    v = torch.rand(SERVE_BUCKET, REF_POINTS,
                   generator=torch.Generator().manual_seed(9))
    outs = {}
    for dev in ("cpu", device):
        _, fn = build_device_forward(torch.float32, dev, 0, REF_SA_NPOINTS,
                                     REF_IMG, REF_POINTS)
        rgb, depth, masks, bboxes, _ = (torch.as_tensor(a).to(dev)
                                        for a in frame)
        with torch.inference_mode():
            pre = preprocess_shared_image(
                rgb, fill_missing(depth[None].float())[0], masks, bboxes,
                torch.tensor(REAL_INTRINSICS), img_size=REF_IMG,
                sample_num=REF_POINTS, v=v)
        ep, _ = fn(*frame, v=v)
        outs[str(dev)] = ({k: t.cpu() for k, t in pre.items()},
                          {k: t.cpu() for k, t in ep.items()})
    (pre_c, ep_c), (pre_g, ep_g) = outs["cpu"], outs[str(device)]
    for name in ("choose", "n_valid", "flat_idx"):
        if not torch.equal(pre_c[name], pre_g[name]):
            raise AssertionError(f"card vs CPU {name} differ")
    k = SERVE_INSTANCES
    pts = (pre_c["pts"][:k] - pre_g["pts"][:k]).abs().max().item()
    rgb_err = (pre_c["rgb"] - pre_g["rgb"]).abs().max().item()
    if pts > REF_PTS_TOL or rgb_err > 1e-5:
        raise AssertionError(f"card vs CPU points {pts} m, rgb {rgb_err}")
    worst = max((ep_c[name][:k] - ep_g[name][:k]).abs().max().item()
                for name in ep_c)
    print(f"[device-reference] card vs CPU at SA npoints {REF_SA_NPOINTS}, "
          f"{REF_IMG}x{REF_IMG}, {REF_POINTS} points, same uniforms: choose, "
          f"n_valid and cell indices equal; points max abs err {pts:.3g} m, "
          f"rgb {rgb_err:.3g}; outputs {worst:.3g}")
    if worst > CPU_ATOL:
        raise AssertionError(f"card vs CPU device forward differ by {worst} "
                             f"> {CPU_ATOL}")


def _busy_share(events) -> float:
    """Union length of the device events over their extent."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, (lo, hi) = 0.0, spans[0]
    for start, end in spans[1:]:
        if start > hi:
            busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    return (busy + hi - lo) / (max(e for _, e in spans) - spans[0][0])


def phase_loops(model, device) -> None:
    """Both device loops over a synthetic tree; same kept instances, finite
    APs; frames/s on the host clock and the card's busy share of each."""
    import logging
    import os
    import pickle
    import tempfile

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from istnet_tpu_torch.data import synthetic
    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS, TestDataset
    from istnet_tpu_torch.eval import nocs_map, test_loop
    from istnet_tpu_torch.utils import Config
    quiet = logging.getLogger("chip_smoke.evaluate")   # keeps the AP tables out
    quiet.setLevel(logging.ERROR)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        synthetic.build_test_tree(root, LOOP_FRAMES, LOOP_INSTANCES)
        print(f"[loops] wrote {LOOP_FRAMES} frames of {LOOP_INSTANCES} "
              f"instances in {time.perf_counter() - t0:.1f} s")
        ds = TestDataset(Config({"img_size": 192, "sample_num": 1024}), root,
                         device_preprocess=True)
        fn = test_loop.make_device_forward(model, REAL_INTRINSICS)

        def per_image(save):
            test_loop.test_func_device(fn, ds, save, progress=False)

        def batched(save):
            test_loop.test_func_device_batched(
                model, ds, save, REAL_INTRINSICS, batch_size=LOOP_BATCH,
                kb=LOOP_KB, progress=False)

        results = {}
        for label, loop in (("test_func_device", per_image),
                            ("test_func_device_batched", batched)):
            loop(os.path.join(root, "warm_" + label))     # first calls
            save = os.path.join(root, label)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof, no_gc():
                t0 = time.perf_counter()
                loop(save)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
            events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = (f"{_busy_share(events):.1%} of the device span "
                    f"({len(events)} device events)" if events
                    else "not measured (the profiler saw no device event)")
            print(f"[loops] {label}: {LOOP_FRAMES} frames in {seconds:.3f} s "
                  f"({LOOP_FRAMES / seconds:.1f} frames/s, "
                  f"{seconds / LOOP_FRAMES * 1e3:.2f} ms a frame, device "
                  f"events traced); card busy {busy}")
            pkls = sorted(f for f in os.listdir(save) if f.endswith(".pkl"))
            if len(pkls) != LOOP_FRAMES:
                raise AssertionError(f"{label}: {len(pkls)} pkls")
            results[label] = []
            for name in pkls:
                with open(os.path.join(save, name), "rb") as f:
                    results[label].append(pickle.load(f))
            iou_aps, pose_aps = nocs_map.evaluate(save, logger=quiet,
                                                  plot_figure=False)
            if not (np.isfinite(iou_aps).all() and np.isfinite(pose_aps).all()):
                raise AssertionError(f"{label}: non-finite APs")
        kept = 0
        for a, b in zip(*results.values()):
            for key in ("pred_class_ids", "pred_bboxes", "pred_scores"):
                if not np.array_equal(a[key], b[key]):
                    raise AssertionError(f"the loops kept different {key}")
            if (a["pred_RTs"].shape != b["pred_RTs"].shape
                    or not np.isfinite(b["pred_RTs"]).all()
                    or not np.isfinite(a["pred_RTs"]).all()):
                raise AssertionError("the loops' poses differ in shape or "
                                     "are not finite")
            kept += len(a["pred_class_ids"])
        print(f"[loops] both loops wrote {LOOP_FRAMES} pkls with the same "
              f"{kept} kept instances; nocs_map.evaluate gives finite APs")


def _config_copy(root: str, name: str, **overrides) -> str:
    """``config/<name>`` written into ``root`` with ``overrides`` set (a
    dotted key reaches into a section); the repo's file stays as it is."""
    import yaml
    with open(os.path.join(REPO, "config", name)) as f:
        data = yaml.safe_load(f)
    for key, value in overrides.items():
        *path, last = key.split(".")
        section = data
        for part in path:
            section = section[part]
        section[last] = value
    out = os.path.join(root, name)
    with open(out, "w") as f:
        yaml.safe_dump(data, f)
    return out


def _device_events(prof):
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def loop_summary(solver):
    """The records of the epochs after the first (all if there is one),
    their median ``T_iter`` / ``T_data`` / ``T_dispatch`` in ms, samples/s
    over them, and the ``T_data`` of each epoch's first batch (it waits for
    its loaders to start again)."""
    import statistics
    records = solver.records
    first = records[0]["epoch"]
    window = [r for r in records if r["epoch"] > first] or records
    batch = solver.syn_loader.batch_size + solver.real_loader.batch_size
    med = {k: statistics.median(r[k] for r in window) * 1e3
           for k in ("T_iter", "T_data", "T_dispatch")}
    rate = batch * len(window) / sum(r["T_iter"] for r in window)
    firsts = [r["T_data"] * 1e3 for i, r in enumerate(window)
              if i == 0 or r["epoch"] != window[i - 1]["epoch"]]
    return window, med, rate, firsts


def run_loop(label: str, argv: list[str], device, per_step: dict,
             bare: float | None = None, profiled: bool = False):
    """``cli/train.py`` main on ``argv``: every loss finite and every
    kernel launched ``per_step`` times a step (counts set to 0 just
    before); prints the medians of ``T_iter`` / ``T_data`` / ``T_dispatch``
    and samples/s over the epochs after the first (all epochs if there is
    one), the card's busy share when ``profiled``, and peak memory.
    Returns the Solver."""
    import statistics

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.cli import train as cli_train
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    ops.reset_launch_counts()
    with contextlib.ExitStack() as stack:
        prof = (stack.enter_context(profile(activities=[ProfilerActivity.CUDA]))
                if profiled else None)
        solver = cli_train.main(argv + ["--device", str(device)])
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    records = solver.records
    steps = len(records)
    want = {k: v * steps for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"[{label}] launches {counts} over {steps} "
                             f"steps, expected {want}")
    bad = [(r["step"], k) for r in records for k, v in r.items()
           if k not in ("epoch", "step") and not np.isfinite(v)]
    if bad:
        raise AssertionError(f"[{label}] non-finite records {bad[:5]}")
    window, med, rate, firsts = loop_summary(solver)
    batch = solver.syn_loader.batch_size + solver.real_loader.batch_size
    busy = ""
    if profiled:
        events = _device_events(prof)
        busy = (f"; card busy {_busy_share(events):.1%} of the device span "
                f"({len(events)} device events, under the profiler)"
                if events else "; card busy not measured (no device event)")
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"[{label}] {steps} steps of B={batch}, losses finite, launches "
          f"per step as expected {({k: v for k, v in per_step.items() if v})}"
          f"; over epochs {window[0]['epoch']}"
          f"-{window[-1]['epoch']} ({len(window)} steps): median T_iter "
          f"{med['T_iter']:.1f} ms (T_data {med['T_data']:.1f}, "
          f"T_dispatch {med['T_dispatch']:.1f}; T_data of an epoch's first "
          f"batch {statistics.median(firsts):.1f}), {rate:.1f} samples/s"
          + (f" (bare step, phase 10: {bare:.1f})" if bare else "")
          + busy + f"; peak memory {peak:.2f} GiB; os.cpu_count() "
          f"{os.cpu_count()}")
    return solver


def phase_train_loop(root: str, device, bare: float):
    """The training loop at full width: ``cli/train.py`` on a copy of
    ``config/ist_net_default.yaml`` cut to LOOP_EPOCHS x LOOP_ITERS over
    the synthetic trees under ``root``; returns the launches of the run and
    the Solver."""
    from istnet_tpu_torch import ops
    cfg = _config_copy(root, "ist_net_default.yaml",
                       max_epoch=LOOP_EPOCHS,
                       num_mini_batch_per_epoch=LOOP_ITERS)
    argv = ["--config", cfg, "--data_dir", os.path.join(root, "data"),
            "--log_dir", os.path.join(root, "log_default")]
    solver = run_loop("train loop", argv, device, TRAIN_PER_STEP, bare)
    return ops.launch_counts(), solver


def phase_resume(root: str, device, trained) -> None:
    """``--checkpoint_epoch LOOP_EPOCHS`` with one more epoch: the model
    and optimizer restored from the checkpoint bit-equal to ``trained``'s
    (the loop's Solver, which wrote it), the first step count, the LR,
    epoch LOOP_EPOCHS + 1 to its end with finite losses; the card's busy
    share over that epoch."""
    from istnet_tpu_torch.cli import train as cli_train
    from istnet_tpu_torch.train import checkpoints
    from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
    from istnet_tpu_torch.utils import Config
    log_dir = os.path.join(root, "log_default")
    cfg_path = _config_copy(root, "ist_net_default.yaml",
                            max_epoch=LOOP_EPOCHS + 1,
                            num_mini_batch_per_epoch=LOOP_ITERS)
    cfg = Config.fromfile(cfg_path)
    train_cfg = TrainConfig.from_config(cfg)
    model = cli_train.build_model(cfg, train_cfg).to(device).train()
    opt = make_optimizer(model, train_cfg)
    ckpt = os.path.join(log_dir, "ckpt")
    checkpoints.restore_checkpoint(ckpt, LOOP_EPOCHS, model, opt)
    _same_state("resume: model", model.state_dict(),
                trained.model.state_dict())
    _same_state("resume: optimizer", opt.state_dict(),
                trained.optimizer.state_dict())
    del model, opt
    solver = run_loop("resume", ["--config", cfg_path, "--data_dir",
                                 os.path.join(root, "data"), "--log_dir",
                                 log_dir, "--checkpoint_epoch",
                                 str(LOOP_EPOCHS)],
                      device, TRAIN_PER_STEP, profiled=True)
    first = solver.records[0]
    if (first["step"], first["epoch"]) != (LOOP_EPOCHS * LOOP_ITERS,
                                            LOOP_EPOCHS + 1):
        raise AssertionError(f"resume: first record {first}")
    if first["lr"] != train_cfg.lr(first["step"]):
        raise AssertionError(f"resume: lr {first['lr']}")
    if len(solver.records) != LOOP_ITERS:
        raise AssertionError(f"resume: {len(solver.records)} steps")
    print(f"[resume] restored model and optimizer bit-equal to the epoch-"
          f"{LOOP_EPOCHS} checkpoint; epoch {LOOP_EPOCHS + 1} from step "
          f"{first['step']} at lr {first['lr']:.6g} ran {LOOP_ITERS} steps")


def _same_state(label: str, got, want) -> None:
    """Nested state dicts equal, tensors bit for bit."""
    import torch
    if isinstance(got, torch.Tensor):
        if not (got.dtype == want.dtype and torch.equal(got, want)):
            raise AssertionError(f"{label} differs")
    elif isinstance(got, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: keys differ")
        for k in got:
            _same_state(f"{label}.{k}", got[k], want[k])
    elif isinstance(got, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{label}: lengths differ")
        for i, (a, b) in enumerate(zip(got, want)):
            _same_state(f"{label}[{i}]", a, b)
    elif got != want:
        raise AssertionError(f"{label}: {got} != {want}")


def phase_two_phase(root: str, device) -> dict:
    """The two-phase recipe at full width through the CLIs: PoseNetGT on a
    copy of ``config/posenet_gt_default.yaml``, its epoch-5 world extractor
    into a copy of ``config/ist_net_freeze_world_enhancer.yaml``, both cut
    to 5 epochs of TWO_PHASE_ITERS, then ``cli/test.py`` from phase 2's
    epoch-5 checkpoint on the card. Checks the launches of both loops, the
    frozen extractor bit-equal to phase 1's after phase 2, finite APs;
    returns phase 1's launches."""
    import numpy as np

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.cli import test as cli_test
    from istnet_tpu_torch.train import checkpoints
    data = ["--data_dir", os.path.join(root, "data")]
    p1_log, p2_log = (os.path.join(root, d) for d in ("log_p1", "log_p2"))
    p1 = _config_copy(root, "posenet_gt_default.yaml", max_epoch=5,
                      num_mini_batch_per_epoch=TWO_PHASE_ITERS)
    run_loop("posenet_gt", ["--config", p1, "--log_dir", p1_log] + data,
             device, POSENET_PER_STEP, profiled=True)
    p1_counts = ops.launch_counts()
    p2 = _config_copy(root, "ist_net_freeze_world_enhancer.yaml", max_epoch=5,
                      num_mini_batch_per_epoch=TWO_PHASE_ITERS,
                      world_enhancer_weights=os.path.join(p1_log, "ckpt"),
                      world_enhancer_epoch=5)
    run_loop("frozen", ["--config", p2, "--log_dir", p2_log] + data, device,
             FROZEN_PER_STEP, profiled=True)
    src = checkpoints.restore_for_eval(os.path.join(p1_log, "ckpt"), 5)["model"]
    dst = checkpoints.restore_for_eval(os.path.join(p2_log, "ckpt"), 5)["model"]
    params = [k for k in dst if k.startswith("world_enhancer.extractor.")
              and "running_" not in k and "num_batches" not in k]
    moved = [k for k in params if not np.array_equal(
        dst[k].numpy(), src["pts_gt_extractor." + k[len("world_enhancer."
                                                       "extractor."):]].numpy())]
    if not params or moved:
        raise AssertionError(f"the frozen extractor moved: {moved[:5]}")
    stats_moved = sum(
        not np.array_equal(dst[k].numpy(), src["pts_gt_extractor." + k[len(
            "world_enhancer.extractor."):]].numpy())
        for k in dst if k.startswith("world_enhancer.extractor.")
        and "running_" in k)
    iou, pose = cli_test.main(["--config", p2, "--data_dir", root,
                               "--log_dir", p2_log, "--test_epoch", "5",
                               "--device", str(device)])
    if not (np.isfinite(iou).all() and np.isfinite(pose).all()):
        raise AssertionError("two-phase: non-finite APs")
    print(f"[two-phase] world_enhancer.extractor's {len(params)} parameters "
          f"bit-equal to phase 1's pts_gt_extractor after phase 2 "
          f"({stats_moved} BN statistics moved, as in the reference); "
          f"cli/test.py from the epoch-5 checkpoint on the card: finite APs")
    return p1_counts


def _raw_batch(root: str, cfg_path: str) -> dict:
    """One raw batch of the device loop: the first batch of each of the
    config's datasets over the trees under ``root`` (18 CAMERA + 6 Real
    frames), concatenated as the Solver does, numpy."""
    from istnet_tpu_torch.data.dataset import TrainingDataset
    from istnet_tpu_torch.data.loader import collate
    from istnet_tpu_torch.train.solver import concat_batches
    from istnet_tpu_torch.utils import Config
    cfg = Config.fromfile(cfg_path)
    dl = cfg.train_dataloader
    parts = []
    for data_type, bs, seed in (("syn", int(dl.syn_bs), 1),
                                ("real_withLabel", int(dl.real_bs), 2)):
        ds = TrainingDataset(cfg.train_dataset, os.path.join(root, "data"),
                             data_type=data_type, num_img_per_epoch=bs,
                             seed=seed, device_preprocess=True)
        ds.reset()
        parts.append(collate([ds[i] for i in range(bs)]))
    return concat_batches(*parts)


def device_call(fn, calls: int = 5) -> tuple[float, float, float]:
    """``fn``'s device us a call (its device events summed, torch.profiler),
    launches a call and host ms to enqueue it (median of ``calls``, no
    sync inside the timed call)."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(calls):
        with no_gc():
            t0 = time.perf_counter()
            fn()
            host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = _device_events(prof)
    us = sum(e.time_range.end - e.time_range.start for e in events) / calls
    return us, len(events) / calls, statistics.median(host)


def sync_sites(fn) -> list[str]:
    """The synchronizing CUDA calls that torch's sync debug mode sees (it
    does not see them all) in one call of ``fn``: the innermost frame of
    this repository's code on each one's stack, as ``file:line``."""
    import traceback
    import warnings

    import torch
    sites = []

    def show(*args, **kwargs):
        frames = [f for f in traceback.extract_stack()
                  if f.filename.startswith(REPO)
                  and not f.filename.endswith("chip_smoke.py")]
        sites.append(f"{os.path.relpath(frames[-1].filename, REPO)}:"
                     f"{frames[-1].lineno}" if frames else "outside the repo")
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sites


def _on(tree, dev):
    """A nested dict of numpy arrays or tensors as tensors on ``dev``."""
    import numpy as np
    import torch
    return {k: _on(v, dev) if isinstance(v, dict) else
            (torch.from_numpy(v) if isinstance(v, np.ndarray) else v
             ).to(dev) for k, v in tree.items()}


def preprocess_card_vs_cpu(tag: str, what: str, raw_np: dict, draws: dict,
                           device, sample_num: int) -> None:
    """``make_train_preprocess`` on the card against the CPU, same raw
    batch and draws: ``choose`` equal, points and ``qo`` within
    PRE_PTS_TOL / PRE_QO_TOL m, rgb within PRE_RGB_TOL of a level."""
    import torch

    from istnet_tpu_torch.data import device_preprocess as dp
    from istnet_tpu_torch.data.transforms import IMAGENET_STD
    preprocess = dp.make_train_preprocess(TRAIN_IMG, sample_num)
    outs = []
    t0 = time.perf_counter()
    for dev in ("cpu", device):
        out = preprocess(_on(raw_np, dev), _on(draws, dev))
        outs.append(_on(out, "cpu"))
    (c, _), (k, _) = ((o["inputs"], o["labels"]) for o in outs)
    scale = torch.from_numpy(IMAGENET_STD * 255)
    errs = {"pts": (k["pts"] - c["pts"]).abs().max().item(),
            "qo": (k["qo"] - c["qo"]).abs().max().item(),
            "rgb": ((k["rgb"] - c["rgb"]) * scale).abs().max().item()}
    b = len(raw_np["depth_raw"])
    if (k["pts"].shape != (b, sample_num, 3)
            or not torch.equal(k["choose"], c["choose"])
            or errs["pts"] > PRE_PTS_TOL or errs["qo"] > PRE_QO_TOL
            or errs["rgb"] > PRE_RGB_TOL):
        raise AssertionError(f"{tag}: card vs CPU preprocessing, points "
                             f"{tuple(k['pts'].shape)}, choose equal "
                             f"{torch.equal(k['choose'], c['choose'])}, {errs}")
    print(f"[{tag}] {what} (B={b}, {tuple(raw_np['depth_raw'].shape[1:])}, "
          f"sample_num {sample_num}), card vs CPU preprocessing with the "
          f"same draws ({time.perf_counter() - t0:.1f} s): choose equal; max "
          f"abs err points {errs['pts']:.3g} m (bound {PRE_PTS_TOL:g}), qo "
          f"{errs['qo']:.3g} ({PRE_QO_TOL:g}), rgb {errs['rgb']:.3g} levels "
          f"({PRE_RGB_TOL:g})")


def phase_device_loop(root: str, device, default_loop) -> tuple[dict, dict]:
    """Phase 18: the device input pipeline at full width. ``cli/train.py``
    on a copy of ``config/ist_net_device_pipeline.yaml`` cut to LOOP_EPOCHS
    x LOOP_ITERS over the trees under ``root``: losses finite, launches
    DEVICE_LOOP_PER_STEP a step, the loop's numbers beside phase 15's
    (``default_loop``'s Solver); the busy share over one more, profiled,
    epoch; then on one raw batch of the trees (B = 24): the card's
    preprocessing against the CPU's with the same draws, and its device us,
    launches and host enqueue ms part by part. Returns the loop's launches
    and kernel 11's case at the path's shape."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.data import device_augment as da
    from istnet_tpu_torch.data import device_preprocess as dp
    from istnet_tpu_torch.data import device_transforms as dt
    from istnet_tpu_torch.train.train_state import prepare_batch
    data = ["--data_dir", os.path.join(root, "data")]
    cfg = _config_copy(root, "ist_net_device_pipeline.yaml",
                       max_epoch=LOOP_EPOCHS,
                       num_mini_batch_per_epoch=LOOP_ITERS)
    solver = run_loop("device loop", ["--config", cfg, "--log_dir",
                                      os.path.join(root, "log_device")]
                      + data, device, DEVICE_LOOP_PER_STEP)
    counts = ops.launch_counts()
    (_, med, rate, _), (_, med15, rate15, _) = (loop_summary(solver),
                                                loop_summary(default_loop))
    print(f"[device loop] beside phase 15 (host data path, same trees): "
          f"{rate:.1f} against {rate15:.1f} samples/s; median T_iter "
          f"{med['T_iter']:.1f} / {med15['T_iter']:.1f} ms, T_data "
          f"{med['T_data']:.1f} / {med15['T_data']:.1f}, T_dispatch "
          f"{med['T_dispatch']:.1f} / {med15['T_dispatch']:.1f}")
    del solver
    one = _config_copy(root, "ist_net_device_pipeline.yaml", max_epoch=1,
                       num_mini_batch_per_epoch=LOOP_ITERS)
    run_loop("device loop, profiled epoch", ["--config", one, "--log_dir",
                                             os.path.join(root, "log_dev1")]
             + data, device, DEVICE_LOOP_PER_STEP, profiled=True)

    raw_np = _raw_batch(root, cfg)
    b = len(raw_np["depth_raw"])
    g = torch.Generator().manual_seed(18)
    pre = dp.draw_preprocess(b, g, TRAIN_POINTS)
    pre["color"] = dt.draw_color_jitter(b, g)
    aug = da.draw_augment(b, g)
    preprocess = dp.make_train_preprocess(TRAIN_IMG, TRAIN_POINTS)
    preprocess_card_vs_cpu("device loop", "one raw batch of the trees",
                           raw_np, pre, device, TRAIN_POINTS)

    r, d_pre, d_aug = (_on(raw_np, device), _on(pre, device),
                       _on(aug, device))
    from istnet_tpu_torch.cli.train import build_model
    from istnet_tpu_torch.train.solver import device_pipeline
    from istnet_tpu_torch.train.train_state import (
        TrainConfig,
        make_optimizer,
        train_step,
    )
    from istnet_tpu_torch.utils import Config
    train_cfg = TrainConfig.from_config(Config.fromfile(cfg))
    model = build_model(Config.fromfile(cfg), train_cfg).to(device).train()
    opt = make_optimizer(model, train_cfg)
    hooks = device_pipeline(Config.fromfile(cfg), torch.float32)
    gen = torch.Generator(device=device).manual_seed(0)
    for step in range(2):
        train_step(model, opt, r, step, gen, train_cfg, *hooks)
    torch.cuda.synchronize()
    sites = sync_sites(lambda: train_step(model, opt, r, 2, gen, train_cfg,
                                          *hooks))
    counted = {site: sites.count(site) for site in sites}
    print(f"[device loop] torch's sync debug mode over one train step on the "
          f"raw batch: {len(sites)} synchronizing calls"
          + (": " + ", ".join(f"{k} x{v}" for k, v in counted.items())
             if sites else ""))
    del model, opt
    depth = dp.fill_missing(r["depth_raw"])
    inst = dp.preprocess_train_instances(
        r["rgb_raw"], depth, r["mask_raw"], r["bbox"], r["intrinsics"],
        r["rotation_label"], r["translation_label"], r["size_label"],
        img_size=TRAIN_IMG, sample_num=TRAIN_POINTS, normalize=False,
        v=d_pre["v"], noise=d_pre["noise"])
    batch = preprocess(r, d_pre)
    augment = da.make_device_augment(0.3, 0.3)
    gen = torch.Generator(device=device).manual_seed(0)
    parts = {
        "fill (kernel 11)": lambda: dp.fill_missing(r["depth_raw"]),
        "crop + sample + back-projection + jitter + qo + resize":
            lambda: dp.preprocess_train_instances(
                r["rgb_raw"], depth, r["mask_raw"], r["bbox"],
                r["intrinsics"], r["rotation_label"], r["translation_label"],
                r["size_label"], img_size=TRAIN_IMG, sample_num=TRAIN_POINTS,
                normalize=False, v=d_pre["v"], noise=d_pre["noise"]),
        "ColorJitter + normalisation":
            lambda: dp.normalize_rgb(dt.color_jitter_batch(inst["rgb"],
                                                           d_pre["color"])),
        "augmentation": lambda: da.device_augment(batch, d_aug),
        "whole, draws included": lambda: prepare_batch(r, gen, preprocess,
                                                       augment),
    }
    for name, fn in parts.items():
        us, launches, host = device_call(fn)
        print(f"[device loop] preprocessing B={b}, {name}: device "
              f"{us / 1e3:.3f} ms in {launches:.0f} launches, host enqueue "
              f"{host:.3f} ms")
    # kernel 11's input on this path: the batch's depth in metres, as
    # fill_missing hands it on
    fill_case = ((dp._div(r["depth_raw"].float(), 1000.0),), True)
    return counts, {"depth_fill": [fill_case]}


def phase_gather_backward(device) -> None:
    """The per-point gather's backward under bf16 at the train step's
    shape (the RGB head's (24, 192, 192, 128) map, 1024 points a sample
    drawn from 300 pixels, so each is chosen ~3.4 times): the card's sums
    bit-equal to the CPU's (both add a pixel's rows in the points' order,
    rounding to bf16 after each add, as JAX's scatter-add does), and a
    second card run bit-equal."""
    import numpy as np
    import torch

    from istnet_tpu_torch.models.ist_net import gather_by_choose
    rng = np.random.RandomState(19)
    b, hw, c = TRAIN_BATCH, TRAIN_IMG, 128
    fmap = torch.from_numpy(rng.randn(b, hw, hw, c).astype("float32")
                            ).bfloat16()
    choose = torch.from_numpy(rng.randint(0, 300, (b, TRAIN_POINTS)))
    cot = torch.from_numpy(rng.randn(b, TRAIN_POINTS, c).astype("float32")
                           ).bfloat16()
    grads = []
    for dev in ("cpu", device, device):
        f = fmap.detach().to(dev).requires_grad_()
        gather_by_choose(f, choose.to(dev)).backward(cot.to(dev))
        grads.append(f.grad.cpu().clone())
    if not (torch.equal(grads[0], grads[1]) and torch.equal(grads[1],
                                                            grads[2])):
        diff = (grads[1].float() - grads[0].float()).abs().max().item()
        raise AssertionError(f"gather_by_choose bf16 backward: card vs CPU "
                             f"max abs diff {diff}")
    print(f"[train-bf16] gather_by_choose backward at ({b}, {hw}, {hw}, "
          f"{c}) bf16, {TRAIN_POINTS} points a sample from 300 pixels: card "
          f"bit-equal to the CPU and to a second card run")


def phase_eval_2048(model, device, per_forward: dict, atol: float,
                    tag: str) -> dict:
    """The full-width eval forward at N = 2048, B = 32 (the 2048-point
    config's ``test.sample_num``): launches and outputs as at N = 1024,
    card against CPU at B = 2 within ``atol``, the forward's ms; returns
    the launches."""
    import torch

    from istnet_tpu_torch.entry import make_inputs
    counts = phase_forward(model, device, per_forward, tag, points=2048)
    phase_reference(model, device, atol, tag, points=2048)
    inp = make_inputs(BATCH, 2048, seed=1, device=device)
    with torch.inference_mode():
        fwd = cuda_ms(lambda: model(inp), iters=10)
    print(f"[timings] {tag}B={BATCH} N=2048 forward {fwd:.3f} ms "
          f"({BATCH / fwd * 1e3:.1f} inf/s)")
    return counts


def phase_sampler_2048(device) -> None:
    """The train-side device sampler at ``sample_num`` 2048 on
    SAMPLER_FRAMES raw frames (``entry.make_train_raw_batch``): the card's
    preprocessing against the CPU's with the same draws."""
    import torch

    from istnet_tpu_torch.data import device_preprocess as dp
    from istnet_tpu_torch.data import device_transforms as dt
    from istnet_tpu_torch.entry import make_train_raw_batch
    raw = {k: v.numpy() for k, v in make_train_raw_batch(
        SAMPLER_FRAMES, seed=21, device="cpu").items()}
    g = torch.Generator().manual_seed(21)
    draws = dp.draw_preprocess(SAMPLER_FRAMES, g, 2048)
    draws["color"] = dt.draw_color_jitter(SAMPLER_FRAMES, g)
    preprocess_card_vs_cpu("sampler 2048", "raw frames", raw, draws, device,
                           2048)


def phase_2048_config(root: str, device) -> dict:
    """``config/ist_net_2048pt_dp.yaml`` through ``cli/train.py`` (the
    frozen recipe under bf16 at 2048 points, B = 18 + 6, the host data
    path), its world enhancer from phase 17's PoseNetGT checkpoint, epochs
    cut to 5 of TWO_PHASE_ITERS; then ``cli/test.py`` on its epoch-5
    checkpoint at ``test.sample_num`` 2048 under bf16: finite APs. Returns
    the loop's launches."""
    import numpy as np

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.cli import test as cli_test
    from istnet_tpu_torch.nn import precision
    log_dir = os.path.join(root, "log_2048")
    cfg = _config_copy(root, "ist_net_2048pt_dp.yaml", max_epoch=5,
                       num_mini_batch_per_epoch=TWO_PHASE_ITERS,
                       world_enhancer_weights=os.path.join(root, "log_p1",
                                                           "ckpt"),
                       world_enhancer_epoch=5)
    solver = run_loop("2048 config", ["--config", cfg, "--log_dir", log_dir,
                                      "--data_dir", os.path.join(root, "data")],
                      device, FROZEN_PER_STEP, profiled=True)
    counts = ops.launch_counts()
    pts = solver.model.pts_cam_extractor
    if (precision.compute_dtype() != precision.dtype_named("bfloat16")
            or not solver.model.freeze_world_enhancer):
        raise AssertionError("2048 config: not the frozen recipe under bf16")
    iou, pose = cli_test.main(["--config", cfg, "--data_dir", root,
                               "--log_dir", log_dir, "--test_epoch", "5",
                               "--device", str(device)])
    if not (np.isfinite(iou).all() and np.isfinite(pose).all()):
        raise AssertionError("2048 config: non-finite APs")
    print(f"[2048 config] frozen recipe under bf16 at 2048 points, SA 1 "
          f"sampling {pts.SA_modules[0].npoint} of them; cli/test.py from "
          f"the epoch-5 checkpoint at test.sample_num 2048 under bf16 on the "
          f"card: finite APs")
    return counts


# data parallelism on one card (phases 23-27)
FPS_LARGE = ((2049, 512), (4096, 512), (8192, 512), (20000, 512))
FPS_LARGE_BATCH = 8
DP_STEPS = 3               # DDP world-1 steps a recipe, bit-equal to plain
DP_RANK_BATCH = TRAIN_BATCH // 2
DP_CLI_EPOCHS = 5          # one step an epoch: the epoch-5 checkpoint


@contextlib.contextmanager
def _launch_env(**env):
    """torchrun's variables set for the block, then restored."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_fps_large(device) -> None:
    """Phase 23: kernel 1 past 2048 points (no shipped config reaches it)
    against its plain version, indices equal, at FPS_LARGE (16 warps of
    registers to 8192 points, then the stream kernel), each case's kernel
    and plain ms, bound and device us a call."""
    import numpy as np
    rng = np.random.RandomState(23)
    cases = {"fps": [((_points(rng, FPS_LARGE_BATCH, n).to(device), npoint),
                      True) for n, npoint in FPS_LARGE]}
    phase_kernels(cases, tag="fps past 2048 ")
    for case in cases["fps"]:
        time_kernels({"fps": [case]}, "fps past 2048 ")


def _whole(t):
    """A tensor whole on this rank, detached (an FSDP shard gathered: a
    collective every rank calls). A shard on a card under gloo (phase 35)
    is gathered by c10d's ``all_gather``, as FSDP2 gathers: DTensor's
    ``full_tensor`` waits on a functional collective there, which ends the
    process with SIGSEGV under torch 2.11 (``PERF.md`` §7)."""
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t.detach()
    if t.device.type != "cuda" or dist.get_backend() != "gloo":
        return t.full_tensor().detach()
    (dim,) = [p.dim for p in t.placements if p.is_shard()]
    world = dist.get_world_size()       # phase 35's mesh: (1, world)
    size = t.shape[dim]
    chunk = -(-size // world)          # torch.chunk's, FSDP2's shards
    local = t.to_local().detach()
    padded = local.new_zeros(local.shape[:dim] + (chunk,)
                             + local.shape[dim + 1:])
    padded.narrow(dim, 0, local.shape[dim]).copy_(local)
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded)
    return torch.cat(parts, dim).narrow(dim, 0, size)


def _state_equal(a: dict, b: dict) -> list:
    """Keys whose tensors differ in any bit."""
    import torch
    return [k for k in a if not torch.equal(a[k], b[k])]


def phase_ddp_world1(device) -> dict:
    """Phase 24: ``multihost.initialize`` under torchrun's variables (world
    1, a free port): NCCL. DP_STEPS steps of the default and the frozen
    recipe at B=24 through ``wrap_dp`` against the plain card step from the
    same state, batches and generator: every loss part and every tensor of
    the state bit-equal, launches as the plain step's; then the default
    step's median ms by CUDA events, DDP and plain in turns, and peak
    memory. Returns the DDP steps' launches."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.parallel import multihost, wrap_dp
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)
    totals: dict = {}
    with _launch_env(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0,
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=_free_port()):
        got = multihost.initialize(device.type)
        backend = torch.distributed.get_backend()
        if backend != ("nccl" if device.type == "cuda" else "gloo") or (
                got != device):
            raise AssertionError(f"world 1: {backend} on {got}")
        try:
            for cfg, per_step in ((TrainConfig(), TRAIN_PER_STEP),
                                  (TrainConfig.frozen(), FROZEN_PER_STEP)):
                recipe = "frozen" if cfg.freeze_world_enhancer else "default"
                runs = []
                for wrap in (False, True):
                    model = build_train_model(
                        device, seed=0, sa_npoints=TRAIN_SA_NPOINTS,
                        freeze_world_enhancer=cfg.freeze_world_enhancer)
                    opt = make_optimizer(model, cfg)
                    step_model = wrap_dp(model) if wrap else model
                    gen = torch.Generator(device=device).manual_seed(0)
                    torch.cuda.synchronize()
                    ops.reset_launch_counts()
                    parts = [train_step(step_model, opt, make_train_batch(
                        TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG, seed=10 + k,
                        device=device), k, gen, cfg) for k in range(DP_STEPS)]
                    torch.cuda.synchronize()
                    counts = ops.launch_counts()
                    want = {k: v * DP_STEPS for k, v in per_step.items()}
                    if counts != want:
                        raise AssertionError(f"ddp world 1 {recipe}: "
                                             f"launches {counts}, expected "
                                             f"{want}")
                    if wrap:
                        for k, v in counts.items():
                            totals[k] = totals.get(k, 0) + v
                    runs.append((parts, model.state_dict()))
                    del model, opt, step_model
                (p0, s0), (p1, s1) = runs
                bad_parts = [(i, k) for i in range(DP_STEPS) for k in p0[i]
                             if not torch.equal(p0[i][k], p1[i][k])]
                bad = _state_equal(s0, s1)
                print(f"[ddp world 1] {recipe}: {DP_STEPS} steps at B="
                      f"{TRAIN_BATCH} over {backend} on {got}: "
                      f"{len(bad_parts)} loss parts and {len(bad)} of "
                      f"{len(s0)} state tensors differ from the plain step's "
                      f"in any bit; launches as the plain step's")
                if bad or bad_parts:
                    raise AssertionError(f"ddp world 1 {recipe}: not "
                                         f"bit-equal: {bad_parts[:3]} "
                                         f"{bad[:3]}")
                del runs, s0, s1
            # timings, the default recipe, plain and DDP in turns
            ms, med, peak, _ = _step_turns(device, "ddp",
                                           lambda m: (m, wrap_dp(m)))
            print(f"[timings] ddp world 1, default step B={TRAIN_BATCH} "
                  f"f32, in turns plain/ddp/ddp/plain, {TIMED_STEPS} steps "
                  f"each: median ddp {med['ddp']:.3f} ms (min "
                  f"{min(ms['ddp']):.3f}, max {max(ms['ddp']):.3f}), plain "
                  f"{med['plain']:.3f} ms (min {min(ms['plain']):.3f}, max "
                  f"{max(ms['plain']):.3f}): "
                  f"{med['ddp'] / med['plain'] - 1:+.1%}"
                  f"; peak memory ddp {peak['ddp']:.2f} GiB, plain "
                  f"{peak['plain']:.2f} GiB")
        finally:
            multihost.shutdown()
    return totals


def _step_turns(device, name: str, wrap,
                rounds: int = 1) -> tuple[dict, dict, dict, list]:
    """The default f32 step at B=24 timed by CUDA events, plain and
    ``name`` in turns (plain, name, name, plain, ``rounds`` times),
    TIMED_STEPS // 2 steps a turn after 2 warm-up steps, each turn from the
    same fresh model; ``wrap(model) -> (model, step_model)`` makes
    ``name``'s. Returns the step ms, their medians and each kind's peak GiB
    (its last turn's), by kind, and for each pair of adjacent turns (1-2,
    3-4, ...) the ratio of ``name``'s median step to plain's."""
    import statistics

    import torch

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)
    cfg = TrainConfig()
    batch = make_train_batch(TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG,
                             seed=30, device=device)
    ms: dict = {"plain": [], name: []}
    peak: dict = {}
    turns = []
    for turn in ("plain", name, name, "plain") * rounds:
        turns.append((turn, []))
        model = build_train_model(device, seed=1,
                                  sa_npoints=TRAIN_SA_NPOINTS)
        model, step_model = (model, model) if turn == "plain" else wrap(model)
        opt = make_optimizer(model, cfg)
        gen = torch.Generator(device=device).manual_seed(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        for step in range(2 + TIMED_STEPS // 2):
            ev = [torch.cuda.Event(enable_timing=True)
                  for _ in range(2)]
            with no_gc():
                ev[0].record()
                train_step(step_model, opt, batch, step, gen, cfg)
                ev[1].record()
                torch.cuda.synchronize()
            if step >= 2:
                turns[-1][1].append(ev[0].elapsed_time(ev[1]))
        ms[turn] += turns[-1][1]
        peak[turn] = torch.cuda.max_memory_allocated(device) / 2 ** 30
        del model, opt, step_model
    ratios = []
    for (a, a_ms), (_, b_ms) in zip(turns[::2], turns[1::2]):
        named, plain = (a_ms, b_ms) if a == name else (b_ms, a_ms)
        ratios.append(statistics.median(named) / statistics.median(plain))
    return (ms, {k: statistics.median(v) for k, v in ms.items()}, peak,
            ratios)


def _gloo_rank(rank: int, world: int, store, out: str, kind: str,
               fsdp: bool = False) -> dict:
    """A rank of phase 25 (35 with ``fsdp``; a spawned process): gloo, on
    ``cuda:0`` as the other rank; its DP_RANK_BATCH rows of the B=24 batch,
    one default step, dropout off, through ``wrap_dp`` (with ``fsdp``: the
    model sharded over a ``(1, world)`` mesh). Rank 0 saves its gradients
    (gathered) to ``out``; each returns its loss parts (averaged over the
    ranks), launches, the digest of its updated state (gathered), its
    step's seconds and its peak GiB (its process's allocations from the
    model's build to the step's end). ``kind``: the device type."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.cli.train import state_digest
    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.parallel import mesh, multihost
    from istnet_tpu_torch.parallel.collectives import all_reduce_mean
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)
    device = multihost.initialize(kind, backend="gloo", store=store,
                                  rank=rank, world_size=world, local_rank=0)
    try:
        torch.cuda.reset_peak_memory_stats(device)
        model = build_train_model(device, seed=4, sa_npoints=TRAIN_SA_NPOINTS)
        _dropout_off(model)
        cfg = TrainConfig()
        if fsdp:
            mesh.shard_state_fsdp(mesh.make_mesh_2d(1, world, kind), model)
        opt = make_optimizer(model, cfg)
        batch = mesh.shard_batch_2d(make_train_batch(
            TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG, seed=6, device=device),
            rank, world)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        parts = train_step(model if fsdp else mesh.wrap_dp(model), opt,
                           batch, 0, torch.Generator(device=device), cfg)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        counts = ops.launch_counts()
        parts = {k: float(all_reduce_mean(v)) for k, v in parts.items()}
        grads = {n: _whole(p.grad).cpu() for n, p in
                 model.named_parameters() if p.grad is not None}
        if rank == 0:
            torch.save(grads, out)
        return {"parts": parts, "counts": counts, "seconds": seconds,
                "peak": peak, "digest": state_digest(
                    {k: _whole(v) for k, v in model.state_dict().items()})}
    finally:
        multihost.shutdown()


def phase_two_ranks_one_card(device, fsdp: bool = False) -> None:
    """Phase 25: the global-batch BatchNorm across 2 ranks that share the
    card (two spawned processes, gloo: NCCL refuses two ranks on one card),
    each with DP_RANK_BATCH rows of a B=24 batch, one full-width f32 step
    against one process's B=24 card step from the same state and batch,
    dropout off: loss parts relative and gradients normwise within phase
    9's full-width bounds (FULL_LOSS_TOL, FULL_GRAD_TOL); both ranks'
    updated parameters and BN running statistics bit-equal (one digest);
    each rank's launches those of a step. Phase 35 (``fsdp``): the same
    with the model sharded over a ``(dp, fsdp) = (1, 2)`` mesh, the ranks'
    parameters gathered for the digest."""
    import tempfile

    import torch

    from istnet_tpu_torch.entry import build_train_model, make_train_batch
    from istnet_tpu_torch.parallel import multihost
    from istnet_tpu_torch.train.train_state import (TrainConfig,
                                                    make_optimizer, train_step)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "grads.pt")
        t0 = time.perf_counter()
        ranks = multihost.spawn(_gloo_rank, 2, out, device.type, fsdp,
                                timeout=600)
        spawn_s = time.perf_counter() - t0
        g_dp = torch.load(out)
    model = build_train_model(device, seed=4, sa_npoints=TRAIN_SA_NPOINTS)
    _dropout_off(model)
    cfg = TrainConfig()
    parts = train_step(model, make_optimizer(model, cfg), make_train_batch(
        TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG, seed=6, device=device), 0,
        torch.Generator(device=device), cfg)
    want = {k: float(v) for k, v in parts.items()}
    g_one = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
             if p.grad is not None}
    del model
    for r, res in enumerate(ranks):
        if res["counts"] != TRAIN_PER_STEP:
            raise AssertionError(f"gloo rank {r}: launches {res['counts']}")
    if set(g_dp) != set(g_one):
        raise AssertionError("2 ranks: other parameters have a gradient")
    loss_err = max(abs(ranks[0]["parts"][k] - v) / max(abs(v), 1e-12)
                   for k, v in want.items())
    g_top = max(g.abs().max().item() for g in g_one.values())
    g_err = max((g_dp[k] - g).abs().max().item()
                for k, g in g_one.items()) / g_top
    same = (len({r["digest"] for r in ranks}) == 1
            and ranks[0]["parts"] == ranks[1]["parts"])
    label = "fsdp (1, 2), two ranks, one card" if fsdp else (
        "two ranks, one card")
    print(f"[{label}] gloo, 2 x B={DP_RANK_BATCH} against one "
          f"process's B={TRAIN_BATCH} card step: loss parts rel err "
          f"{loss_err:.3g} (bound {FULL_LOSS_TOL:g}); gradients normwise "
          f"{g_err:.3g} (bound {FULL_GRAD_TOL:g}; max|g| {g_top:.3g}); the "
          f"ranks' updated parameters, BN running statistics and loss parts "
          f"{'bit-equal' if same else 'DIFFER'}; launches a rank "
          f"{TRAIN_PER_STEP}; a rank's step {ranks[0]['seconds']:.2f} / "
          f"{ranks[1]['seconds']:.2f} s under gloo (host round trips, not "
          f"what NCCL would give), peak memory a rank {ranks[0]['peak']:.3f}"
          f" / {ranks[1]['peak']:.3f} GiB, the phase {spawn_s:.1f} s with "
          f"the processes' start")
    if not same or loss_err > FULL_LOSS_TOL or g_err > FULL_GRAD_TOL:
        raise AssertionError(f"{label}: out of bounds")


def torchrun_train_child(out: str, argv: list) -> None:
    """``chip_smoke.py --torchrun-train OUT ARGS``: a process torchrun
    started runs ``cli/train.py`` on ARGS, launch counts set to 0 just
    before, and writes its records, launches and whether the Solver ran
    DDP to OUT (JSON)."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.cli import train as cli_train
    from istnet_tpu_torch.parallel import multihost
    # joined here (cli/train.py joins the group it finds), so that the
    # backend can be read
    multihost.initialize(cli_train.parse_args(argv).device)
    try:
        backend = torch.distributed.get_backend()
        ops.reset_launch_counts()
        solver = cli_train.main(argv)
        counts = ops.launch_counts()
    finally:
        multihost.shutdown()
    with open(out, "w") as f:
        json.dump({"records": solver.records, "counts": counts,
                   "ddp": type(solver.model).__name__, "backend": backend,
                   "world": int(os.environ["WORLD_SIZE"])}, f)


def phase_torchrun_cli(root: str, device) -> dict:
    """Phase 26: ``cli/train.py`` under torchrun (``python -m
    torch.distributed.run --standalone --nproc_per_node 1``: world 1,
    NCCL, DDP) on a copy of ``config/ist_net_default.yaml`` cut to
    DP_CLI_EPOCHS epochs of one step, over phase 15's trees: every loss
    finite, TRAIN_PER_STEP launches a step, the epoch-5 checkpoint with the
    reference keys; then ``cli/test.py --devices 1`` from it on the card
    (batched DP inference): finite APs. Returns the loop's launches."""
    import numpy as np

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.cli import test as cli_test
    from istnet_tpu_torch.models.ist_net import ISTNet
    from istnet_tpu_torch.train import checkpoints
    cfg = _config_copy(root, "ist_net_default.yaml", max_epoch=DP_CLI_EPOCHS,
                       num_mini_batch_per_epoch=1)
    log_dir = os.path.join(root, "log_torchrun")
    out = os.path.join(root, "torchrun.json")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.join(REPO, "chip_smoke.py"),
           "--torchrun-train", out, "--config", cfg, "--data_dir",
           os.path.join(root, "data"), "--log_dir", log_dir, "--device",
           str(device)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"torchrun cli/train.py failed "
                             f"({proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-6000:]}")
    with open(out) as f:
        child = json.load(f)
    steps = len(child["records"])
    want = {k: v * steps for k, v in TRAIN_PER_STEP.items()}
    bad = [r["step"] for r in child["records"]
           if not np.isfinite(r["total"])]
    if (child["counts"] != want or bad or steps != DP_CLI_EPOCHS
            or child["ddp"] != "DistributedDataParallel"
            or child["world"] != 1 or child["backend"] != (
                "nccl" if device.type == "cuda" else "gloo")):
        raise AssertionError(f"torchrun cli/train.py: {child['counts']} "
                             f"(want {want}), {steps} steps, non-finite "
                             f"{bad}, model {child['ddp']}")
    saved = checkpoints.restore_for_eval(os.path.join(log_dir, "ckpt"),
                                         DP_CLI_EPOCHS)["model"]
    if list(saved) != list(ISTNet().state_dict()):
        raise AssertionError("torchrun checkpoint: not the reference keys")
    ops.reset_launch_counts()
    iou, pose = cli_test.main(["--config", cfg, "--data_dir", root,
                               "--log_dir", log_dir, "--test_epoch",
                               str(DP_CLI_EPOCHS), "--devices", "1",
                               "--device", str(device)])
    test_counts = {k: v for k, v in ops.launch_counts().items() if v}
    if not (np.isfinite(iou).all() and np.isfinite(pose).all()):
        raise AssertionError("cli/test.py --devices 1: non-finite APs")
    print(f"[torchrun] cli/train.py under torchrun (world 1, "
          f"{child['backend']}, {child['ddp']}): {steps} steps of B="
          f"{TRAIN_BATCH}, losses "
          f"finite (last {child['records'][-1]['total']:.4f}), launches "
          f"{TRAIN_PER_STEP} a step, the epoch-{DP_CLI_EPOCHS} checkpoint "
          f"with the {len(saved)} reference keys ({seconds:.1f} s with "
          f"torchrun's start); cli/test.py --devices 1 on it: finite APs, "
          f"launches {test_counts}")
    return child["counts"]


def phase_eval_dp(model, device) -> dict:
    """Phase 27: ``eval_forward_dp`` over two replicas on the card
    (``[cuda:0, cuda:0]``) against the unsplit B=32 f32 forward: every
    output within CPU_ATOL; launches twice a forward's (each replica runs
    B=16); ms of both by CUDA events. Returns the DP forward's launches."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_inputs
    from istnet_tpu_torch.parallel import eval_forward_dp
    inputs = make_inputs(BATCH, seed=27, device=device)
    forward = eval_forward_dp(model, [device, device])
    with torch.inference_mode():
        want = model(inputs)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    got = forward(inputs)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expect = {k: 2 * v for k, v in F32_PER_FORWARD.items()}
    if {k: v for k, v in counts.items() if v} != {
            k: v for k, v in expect.items() if v}:
        raise AssertionError(f"eval dp: launches {counts}, expected {expect}")
    err = max((got[k] - w).abs().max().item() for k, w in want.items())
    if set(got) != set(want) or not err <= CPU_ATOL:
        raise AssertionError(f"eval dp: max abs err {err} (bound {CPU_ATOL})")
    with torch.inference_mode():
        dp_ms = cuda_ms(lambda: forward(inputs), iters=5)
        one_ms = cuda_ms(lambda: model(inputs), iters=5)
    print(f"[eval dp] eval_forward_dp over [{device}, {device}] (2 x B="
          f"{BATCH // 2}) against the unsplit B={BATCH} forward: max abs err "
          f"{err:.3g} (bound {CPU_ATOL:g}); launches {counts}; "
          f"{dp_ms:.3f} ms a batch against {one_ms:.3f} ms")
    return counts


def _fsdp_compare(label: str, plain, sharded) -> None:
    """Phase 33's check of two runs ``(loss parts a step, gradients of the
    last step, state)``: bit-equal, or the loss parts and the gradients
    within phase 9's full-width bounds, the differences printed."""
    import torch
    (p0, g0, s0), (p1, g1, s1) = plain, sharded
    bad_parts = [(i, k) for i in range(len(p0)) for k in p0[i]
                 if not torch.equal(p0[i][k], p1[i][k])]
    bad = _state_equal(s0, s1) + [k for k in g0 if k in g1
                                  and not torch.equal(g0[k], g1[k])]
    loss_err = max(abs(float(p1[i][k]) - float(v)) / max(abs(float(v)), 1e-12)
                   for i in range(len(p0)) for k, v in p0[i].items())
    g_top = max(g.abs().max().item() for g in g0.values())
    g_err = max((g1[k].float() - g.float()).abs().max().item()
                for k, g in g0.items() if k in g1) / g_top
    print(f"[fsdp world 1] {label}: {len(bad_parts)} loss parts and "
          f"{len(bad)} of {len(s0) + len(g0)} state and gradient tensors "
          f"differ from the plain step's in any bit (loss parts rel err "
          f"{loss_err:.3g}, bound {FULL_LOSS_TOL:g}; last step's gradients "
          f"normwise {g_err:.3g}, bound {FULL_GRAD_TOL:g})")
    if set(g0) != set(g1) or list(s0) != list(s1) or (
            (bad or bad_parts) and (loss_err > FULL_LOSS_TOL
                                    or g_err > FULL_GRAD_TOL)):
        raise AssertionError(f"fsdp world 1 {label}: out of bounds")


def _steps(model, opt, cfg, device, per_step: dict, label: str):
    """DP_STEPS steps of the batches seeded 10.. from generator seed 0,
    launches checked against ``per_step`` a step; returns the loss parts,
    the last step's gradients and the state, whole, and the launches."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_train_batch
    from istnet_tpu_torch.train.train_state import train_step
    gen = torch.Generator(device=device).manual_seed(0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    parts = [train_step(model, opt, make_train_batch(
        TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG, seed=10 + k, device=device),
        k, gen, cfg) for k in range(DP_STEPS)]
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {k: v * DP_STEPS for k, v in per_step.items()}
    if counts != want:
        raise AssertionError(f"{label}: launches {counts}, expected {want}")
    grads = {n: _whole(p.grad) for n, p in model.named_parameters()
             if p.grad is not None}
    state = {k: _whole(v).clone() for k, v in model.state_dict().items()}
    return (parts, grads, state), counts, gen


def phase_fsdp_world1(device) -> dict:
    """Phase 33: ``multihost.initialize`` under torchrun's variables (world
    1, NCCL), a ``(1, 1)`` mesh (``make_mesh_2d``); DP_STEPS steps at B=24
    of the f32 default and frozen recipes and the bf16 default one, the
    model sharded by ``shard_state_fsdp`` against the plain card step from
    the same state, batches and generator (``_fsdp_compare``), launches as
    the plain step's; the f32 default step's median ms, FSDP and plain in
    FSDP_TIMING_ROUNDS rounds of turns with each adjacent pair's ratio,
    and peak memory. Phase 34 runs on the f32 default FSDP run. Returns
    the FSDP steps' launches by compute dtype."""
    import statistics

    import torch

    from istnet_tpu_torch.entry import build_train_model
    from istnet_tpu_torch.parallel import (make_mesh_2d, multihost,
                                           shard_state_fsdp)
    from istnet_tpu_torch.train.train_state import TrainConfig, make_optimizer
    totals: dict = {"float32": {}, "bfloat16": {}}
    with _launch_env(RANK=0, WORLD_SIZE=1, LOCAL_RANK=0,
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=_free_port()):
        got = multihost.initialize(device.type)
        backend = torch.distributed.get_backend()
        if backend != ("nccl" if device.type == "cuda" else "gloo") or (
                got != device):
            raise AssertionError(f"world 1: {backend} on {got}")
        try:
            mesh = make_mesh_2d(1, 1, device.type)
            for dtype, cfg, per_step in (
                    (torch.float32, TrainConfig(), TRAIN_PER_STEP),
                    (torch.float32, TrainConfig.frozen(), FROZEN_PER_STEP),
                    (torch.bfloat16, TrainConfig(), TRAIN_PER_STEP)):
                label = (f"{'bf16' if dtype == torch.bfloat16 else 'f32'} "
                         f"{'frozen' if cfg.freeze_world_enhancer else 'default'}")
                runs = []
                with policy(dtype):
                    for sharded in (False, True):
                        model = build_train_model(
                            device, seed=0, sa_npoints=TRAIN_SA_NPOINTS,
                            freeze_world_enhancer=cfg.freeze_world_enhancer,
                            dtype=dtype)
                        if sharded:
                            shard_state_fsdp(mesh, model)
                        opt = make_optimizer(model, cfg)
                        run, counts, gen = _steps(
                            model, opt, cfg, device, per_step,
                            f"{'fsdp' if sharded else 'plain'} {label}")
                        runs.append(run)
                        if sharded:
                            tally = totals[str(dtype).removeprefix("torch.")]
                            for k, v in counts.items():
                                tally[k] = tally.get(k, 0) + v
                        if sharded and label == "f32 default":
                            _fsdp_compare(label, *runs)
                            phase_sharded_checkpoint(device, mesh, model,
                                                     opt, gen, cfg)
                        del model, opt
                if label != "f32 default":
                    _fsdp_compare(label, *runs)
                del runs
            ms, med, peak, ratios = _step_turns(
                device, "fsdp", lambda m: (shard_state_fsdp(mesh, m),) * 2,
                rounds=FSDP_TIMING_ROUNDS)
            print(f"[timings] fsdp world 1, default step B={TRAIN_BATCH} "
                  f"f32, in turns plain/fsdp/fsdp/plain x "
                  f"{FSDP_TIMING_ROUNDS}, {TIMED_STEPS // 2} steps a turn: "
                  f"median fsdp {med['fsdp']:.3f} ms (min "
                  f"{min(ms['fsdp']):.3f}, max {max(ms['fsdp']):.3f}), plain "
                  f"{med['plain']:.3f} ms (min {min(ms['plain']):.3f}, max "
                  f"{max(ms['plain']):.3f}): "
                  f"{med['fsdp'] / med['plain'] - 1:+.1%}; median of the "
                  f"{len(ratios)} adjacent turn pairs' ratios "
                  f"{statistics.median(ratios) - 1:+.1%} (pairs "
                  + ", ".join(f"{r - 1:+.1%}" for r in ratios)
                  + f"); peak memory fsdp {peak['fsdp']:.2f} GiB, plain "
                  f"{peak['plain']:.2f} GiB")
        finally:
            multihost.shutdown()
    return totals


def phase_sharded_checkpoint(device, mesh, model, opt, gen, cfg) -> None:
    """Phase 34: phase 33's f32 default FSDP state after DP_STEPS steps
    saved sharded (DCP); the next step of the unbroken run against the
    same step of a fresh sharded model and optimizer restored by
    ``restore_checkpoint_sharded``: loss parts and state bit-equal. The
    same state read into a plain model and optimizer by
    ``restore_checkpoint`` and saved plain (a DDP run's layout), then
    ``restore_checkpoint_sharded`` of that file into another fresh sharded
    model (rank 0's broadcast over NCCL): its next step bit-equal too. Then
    ``restore_for_eval`` of the sharded directory into the plain eval model
    on the card: the B=32 f32 eval forward launches F32_PER_FORWARD and
    equals, bit for bit, the forward of the FSDP run's gathered weights.
    Save and restore seconds."""
    import tempfile

    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import (build_model, build_train_model,
                                        make_inputs, make_train_batch)
    from istnet_tpu_torch.parallel import shard_state_fsdp
    from istnet_tpu_torch.train import checkpoints
    from istnet_tpu_torch.train.train_state import make_optimizer, train_step
    gathered = {k: _whole(v).clone() for k, v in model.state_dict().items()}
    batch = make_train_batch(TRAIN_BATCH, TRAIN_POINTS, TRAIN_IMG,
                             seed=10 + DP_STEPS, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoints.save_checkpoint(tmp, 1, model, opt, DP_STEPS)
        save_s = time.perf_counter() - t0
        files = sorted(os.listdir(os.path.join(tmp, "1")))
        size = sum(os.path.getsize(os.path.join(tmp, "1", f)) for f in files)
        gen_state = gen.get_state()
        p_unbroken = train_step(model, opt, batch, DP_STEPS, gen, cfg)
        s_unbroken = {k: _whole(v).clone()
                      for k, v in model.state_dict().items()}
        fresh = build_train_model(device, seed=7, sa_npoints=TRAIN_SA_NPOINTS)
        shard_state_fsdp(mesh, fresh)
        fresh_opt = make_optimizer(fresh, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step, meta = checkpoints.restore_checkpoint_sharded(tmp, 1, fresh,
                                                            fresh_opt)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        gen.set_state(gen_state)
        p_resumed = train_step(fresh, fresh_opt, batch, step, gen, cfg)
        s_resumed = {k: _whole(v).clone()
                     for k, v in fresh.state_dict().items()}
        bad = _state_equal(s_unbroken, s_resumed) + [
            k for k in p_unbroken if not torch.equal(p_unbroken[k],
                                                     p_resumed[k])]
        del fresh, fresh_opt, s_resumed
        # the same state in the plain layout, resumed sharded
        plain = build_train_model(device, seed=8, sa_npoints=TRAIN_SA_NPOINTS)
        plain_opt = make_optimizer(plain, cfg)
        checkpoints.restore_checkpoint(tmp, 1, plain, plain_opt)
        plain_dir = os.path.join(tmp, "plain")
        checkpoints.save_checkpoint(plain_dir, 1, plain, plain_opt, DP_STEPS)
        del plain, plain_opt
        fresh = build_train_model(device, seed=9, sa_npoints=TRAIN_SA_NPOINTS)
        shard_state_fsdp(mesh, fresh)
        fresh_opt = make_optimizer(fresh, cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain_step, plain_meta = checkpoints.restore_checkpoint_sharded(
            plain_dir, 1, fresh, fresh_opt)
        torch.cuda.synchronize()
        plain_restore_s = time.perf_counter() - t0
        gen.set_state(gen_state)
        p_resumed = train_step(fresh, fresh_opt, batch, plain_step, gen, cfg)
        s_resumed = {k: _whole(v).clone()
                     for k, v in fresh.state_dict().items()}
        bad_plain = _state_equal(s_unbroken, s_resumed) + [
            k for k in p_unbroken if not torch.equal(p_unbroken[k],
                                                     p_resumed[k])]
        del fresh, fresh_opt, s_unbroken, s_resumed
        t0 = time.perf_counter()
        saved = checkpoints.restore_for_eval(tmp, 1, map_location=device)
        eval_s = time.perf_counter() - t0
    evald, ref = build_model(device, seed=3), build_model(device, seed=4)
    evald.load_state_dict(saved["model"], strict=True)
    ref.load_state_dict(gathered, strict=True)
    inputs = make_inputs(BATCH, seed=34, device=device)
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        got = evald(inputs)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = ref(inputs)
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    print(f"[sharded checkpoint] DCP save of the f32 FSDP state after "
          f"{DP_STEPS} steps: {save_s:.3f} s, {len(files)} files, "
          f"{size / 2 ** 20:.1f} MiB; restore_checkpoint_sharded into a "
          f"fresh sharded model and optimizer {restore_s:.3f} s (step {step}, "
          f"meta {meta}); the next step {len(bad)} tensors and loss parts "
          f"off the unbroken run's in any bit; from the same state saved "
          f"plain, restore_checkpoint_sharded {plain_restore_s:.3f} s (step "
          f"{plain_step}), the next step {len(bad_plain)} off in any bit; "
          f"restore_for_eval on the card "
          f"{eval_s:.3f} s, its B={BATCH} eval forward: launches {counts}, "
          f"{len(differ)} of {len(want)} outputs off the gathered weights' "
          f"forward in any bit")
    if (bad or bad_plain or differ or step != DP_STEPS
            or meta != {"epoch": 1} or plain_step != DP_STEPS
            or plain_meta != {"epoch": 1}
            or {k: v for k, v in counts.items() if v}
            != {k: v for k, v in F32_PER_FORWARD.items() if v}):
        raise AssertionError(f"sharded checkpoint: {bad[:3]} "
                             f"{bad_plain[:3]} {differ[:3]} {counts}")


# the trunk backends (phase 28): each one's encoder alone at the eval
# forward's shapes (B=32, 192^2, 1024 chosen pixels) and a train-mode step
# at the train batch; the card against the CPU at B=2 within phase 5's
# bounds (f32 CPU_ATOL, bf16 BF16_CPU_ATOL)
TRUNKS = ("resnet18", "resnet34", "resnet50", "resnet101", "resnet152")
TRUNK_PER_FORWARD = {"fold_upsample": 1}
# the card's and the CPU's data preparation (phase 30): CAMERA-train labels,
# both RANSACs converged to the all-inlier refit in float32
PREP_RANSAC_TOL = 1e-5
# points of the RANSAC's timed instances: the synthetic tree's largest
# (80 x 60), then real NOCS masks, of a mid-sized and of the largest
# instances (up to ~2.6e5 of a 480 x 640 frame)
RANSAC_POINTS = (80 * 60, 20_000, 260_000)
# the device kernels of each wrapper's launch in a torch.profiler trace
# (phase 32): one a launch (the fold's GEMM; its interpolation follows it)
TRACE_KERNELS = {"fps": r"\bfps(_stream)?_kernel\b",
                 "ball_query_group": r"\bbq_group(_global)?_kernel\b",
                 "fp_interpolate": r"\bfp_interp_kernel\b",
                 "fold_upsample": r"\bgemm_(f32|bf16)_kernel\b",
                 "bn_eval": r"\bbn_eval(_scalar)?_kernel\b"}
PROFILED_FORWARDS = 3


def phase_trunks(device) -> dict:
    """Phase 28: every trunk backend's encoder (``entry.build_encoder``:
    seeded weights, BN statistics of a seeded batch) at B=32, 192^2 under
    float32 and bf16: the dense ``forward`` and ``sparse_points`` at 1024
    chosen pixels, finite and of their shapes, the fold kernel launched once
    a forward; the same encoder on the card against the port's CPU encoder
    at B=2 (dense and sparse), reported against phase 5's bounds, and both
    against the CPU's float64 forward: the card's error at most twice the
    CPU's at the same policy (at random weights the deep trunks amplify
    rounding, so float32 itself misses phase 5's bound there); ms by CUDA
    events and peak memory above what was allocated before ("+"); one
    train-mode forward and backward at B=TRAIN_BATCH with finite gradients,
    its ms and peak memory. The fold kernel against its plain version on
    the input up_2 takes in each trunk's B=32 forward, at phase 3's bounds,
    and its times there. Returns, by policy, the launches, the fold's worst
    error and its times (``time_kernels``'s, the mean over the trunks)."""
    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import build_encoder, make_inputs
    from istnet_tpu_torch.nn.layers import BatchNorm, cast
    from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet
    inp = make_inputs(BATCH, seed=28, device=device)
    rgb, choose = inp["rgb"], inp["choose"]
    ref = make_inputs(2, seed=29, device="cpu")
    launched = {dtype: dict.fromkeys(ops.launch_counts(), 0)
                for dtype in ("float32", "bfloat16")}
    fold_errs = dict.fromkeys(launched, 0.0)
    fold_times = {dtype: [] for dtype in launched}
    misses = []
    for backend in TRUNKS:
        t0 = time.perf_counter()
        enc = build_encoder(backend, device, seed=28)
        # the eval BN pass: every BN but up_2's, once a forward
        bns = sum(isinstance(m, BatchNorm) for m in enc.modules()) - 1
        up_2_input = []
        hook = enc.model.up_2.register_forward_pre_hook(
            lambda mod, args: up_2_input.append(cast(args[0]))
            if not up_2_input else None)
        cpu = ModifiedResnet(backend)
        cpu.load_state_dict({k: v.cpu() for k, v in enc.state_dict().items()})
        cpu.eval()
        with policy(torch.float64), torch.inference_mode():
            ref64 = _encoder_outputs(copy.deepcopy(cpu).double(),
                                     {"rgb": ref["rgb"].double(),
                                      "choose": ref["choose"]}, "cpu")
        n_params = sum(p.numel() for p in enc.parameters()) / 1e6
        line = [f"[trunks] {backend}: {n_params:.2f}M parameters"]
        for dtype, atol in ((torch.float32, CPU_ATOL),
                            (torch.bfloat16, BF16_CPU_ATOL)):
            tag = "f32" if dtype == torch.float32 else "bf16"
            name = str(dtype).removeprefix("torch.")
            with policy(dtype), torch.inference_mode():
                torch.cuda.synchronize()
                up_2_input.clear()
                ops.reset_launch_counts()
                dense = enc(rgb)
                sparse = enc.sparse_points(rgb, choose)
                torch.cuda.synchronize()
                counts = ops.launch_counts()
                per_forward = {**TRUNK_PER_FORWARD, "bn_eval": bns}
                want = {k: 2 * per_forward.get(k, 0) for k in counts}
                if counts != want:
                    raise AssertionError(f"trunks {backend} {tag}: launches "
                                         f"{counts}, expected {want}")
                for k, v in counts.items():
                    launched[name][k] += v
                # the fold kernel on this trunk's own up_2 input
                fold_case = {"fold_upsample": [(
                    (up_2_input[0], enc.model.up_2.packed()), True)]}
                fold_errs[name] = max(fold_errs[name], phase_kernels(
                    fold_case, bf16=dtype == torch.bfloat16,
                    tag=f"trunks {backend} ")["fold_upsample"])
                fold_times[name].append(time_kernels(
                    fold_case, f"trunks {backend} {tag} ")["fold_upsample"])
                del fold_case
                up_2_input.clear()
                if (tuple(dense.shape) != (BATCH, 192, 192, 128)
                        or tuple(sparse.shape) != (BATCH, 1024, 128)
                        or not torch.isfinite(dense).all()
                        or not torch.isfinite(sparse).all()):
                    raise AssertionError(f"trunks {backend} {tag}: outputs "
                                         f"{tuple(dense.shape)} / "
                                         f"{tuple(sparse.shape)} or not finite")
                del dense, sparse
                card = _encoder_outputs(enc, ref, device)
                host = _encoder_outputs(cpu, ref, "cpu")
                errs = [(g - w).abs().max().item() for g, w in zip(card, host)]
                # both against the CPU's float64 forward: the card's error
                # within twice the CPU's own at this policy
                card64, cpu64 = ([(o.double() - w).abs().max().item()
                                  for o, w in zip(outs, ref64)]
                                 for outs in (card, host))
                if max(card64) > 2 * max(cpu64):
                    raise AssertionError(
                        f"trunks {backend} {tag}: the card {card64} from the "
                        f"float64 forward, the CPU {cpu64}")
                scale = max(w.abs().max().item() for w in ref64)
                if max(errs) > atol:
                    misses.append(f"{backend} {tag} {max(errs):.3g}")
                torch.cuda.reset_peak_memory_stats(device)
                base = torch.cuda.memory_allocated(device)
                dense_ms = cuda_ms(lambda: enc(rgb), iters=5)
                sparse_ms = cuda_ms(lambda: enc.sparse_points(rgb, choose),
                                    iters=5)
                peak = (torch.cuda.max_memory_allocated(device) - base) / 2**30
            line.append(
                f"{tag}: dense {dense_ms:.3f} ms, sparse {sparse_ms:.3f} ms "
                f"a B={BATCH} forward, peak +{peak:.2f} GiB; B=2 card vs CPU "
                f"max abs err dense {errs[0]:.3g}, sparse {errs[1]:.3g} "
                f"(max |out| {scale:.3g}; phase 5's bound {atol:g}: "
                f"{'within' if max(errs) <= atol else 'MISS'}); from the CPU "
                f"float64 forward: card {max(card64):.3g}, CPU "
                f"{max(cpu64):.3g}")
        hook.remove()
        with policy(torch.float32):
            enc.train()
            gen = torch.Generator(device=device).manual_seed(28)
            x = rgb[:TRAIN_BATCH].clone()

            def step():
                enc.zero_grad(set_to_none=True)
                enc(x, gen).float().square().mean().backward()

            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            step()
            grads = [p.grad for p in enc.parameters() if p.grad is not None]
            if not grads or not all(torch.isfinite(g).all() for g in grads):
                raise AssertionError(f"trunks {backend}: gradients missing "
                                     f"or not finite")
            train_ms = cuda_ms(step, iters=3, warmup=1)
            train_peak = (torch.cuda.max_memory_allocated(device)
                          - base) / 2 ** 30
            enc.zero_grad(set_to_none=True)
            enc.eval()
        line.append(f"train-mode forward + backward at B={TRAIN_BATCH}: "
                    f"{train_ms:.3f} ms, gradients finite ({len(grads)} "
                    f"tensors), peak +{train_peak:.2f} GiB; phase "
                    f"{time.perf_counter() - t0:.1f} s")
        print("; ".join(line))
        del enc, cpu
        torch.cuda.empty_cache()
    print(f"[trunks] card vs CPU beyond phase 5's bounds (reported, not "
          f"widened): {', '.join(misses) if misses else 'none'}")
    times = {}
    for name, rows in fold_times.items():
        # (kernel, plain, bound ms; what bounds it; library ms, None here)
        k_ms, p_ms, least = (sum(r[i] for r in rows) / len(rows)
                             for i in range(3))
        times[name] = {"fold_upsample": (k_ms, p_ms, least, *rows[0][3:])}
    return {name: (launched[name], {"fold_upsample": fold_errs[name]},
                   times[name]) for name in launched}


def _encoder_outputs(enc, inputs, device):
    """The dense map and the sparse head of ``enc`` on ``inputs`` moved to
    ``device``, as float32 (float64 from a float64 model) CPU tensors."""
    import torch
    rgb, choose = inputs["rgb"].to(device), inputs["choose"].to(device)
    return [o.cpu() if o.dtype == torch.float64 else o.float().cpu()
            for o in (enc(rgb), enc.sparse_points(rgb, choose))]


def phase_pretrained_backbone(device) -> None:
    """Phase 29: a torchvision-layout resnet18 state dict made from a seed
    through ``cli/convert_torch_resnet.py`` to a ``.npz``, then
    ``cli/train.py --pretrained_backbone`` on the default config over
    phase 15's kind of trees for 1 epoch of 2 steps: the trunk equal to the
    file before step 1, losses finite, TRAIN_PER_STEP launches a step; a
    resnet50-layout dict converts and loads into
    ``ModifiedResnet("resnet50")`` on the card, whose forward is finite."""
    import tempfile

    import numpy as np
    import torch

    from istnet_tpu_torch.cli import convert_torch_resnet as convert
    from istnet_tpu_torch.data import synthetic
    from istnet_tpu_torch.entry import random_resnet_state_dict
    from istnet_tpu_torch.nn.resnet_psp import ModifiedResnet
    from istnet_tpu_torch.train.solver import Solver
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        synthetic.build_train_trees(os.path.join(root, "data"), LOOP_SCENES)
        files = {}
        for seed, backend in enumerate(("resnet18", "resnet50")):
            pth = os.path.join(root, f"{backend}.pth")
            torch.save(random_resnet_state_dict(backend, 29 + seed), pth)
            files[backend] = pth, convert.main(
                ["--torch_ckpt", pth, "--out",
                 os.path.join(root, f"{backend}.npz")])
        want = convert.torch_sd_to_numpy(files["resnet18"][0])
        seen = {}
        solve = Solver.solve

        def checked(self):
            sd = self.model.state_dict()
            seen.update({k: sd["rgb_cam_extractor.model.feats." + k].cpu()
                         .numpy().copy() for k in want})
            return solve(self)

        cfg = _config_copy(root, "ist_net_default.yaml", max_epoch=1,
                           num_mini_batch_per_epoch=2)
        Solver.solve = checked
        try:
            run_loop("pretrained backbone",
                     ["--config", cfg, "--data_dir", os.path.join(root, "data"),
                      "--log_dir", os.path.join(root, "log"),
                      "--pretrained_backbone", files["resnet18"][1]],
                     device, TRAIN_PER_STEP)
        finally:
            Solver.solve = solve
        off = [k for k, w in want.items() if not k.endswith(
            "num_batches_tracked") and not np.array_equal(seen[k], w)]
        if set(seen) != set(want) or off:
            raise AssertionError(f"pretrained backbone: the trunk before "
                                 f"step 1 is not the file's: {off[:5]}")
        enc = ModifiedResnet("resnet50")
        written = convert.load_pretrained_backbone(enc, files["resnet50"][1],
                                                   encoder="")
        enc = enc.to(device).eval()
        want50 = convert.torch_sd_to_numpy(files["resnet50"][0])
        got50 = enc.state_dict()
        off = [k for k, w in want50.items() if not k.endswith(
            "num_batches_tracked") and not np.array_equal(
                got50["model.feats." + k].cpu().numpy(), w)]
        with torch.inference_mode(), policy(torch.float32):
            out = enc(torch.rand(2, 192, 192, 3, device=device))
        if off or not torch.isfinite(out).all():
            raise AssertionError(f"pretrained backbone: resnet50 off {off[:5]}"
                                 f" or its forward not finite")
        print(f"[pretrained backbone] the resnet18 trunk equals the .npz "
              f"before step 1 ({len(want)} arrays); a resnet50-layout dict "
              f"converted and loaded into ModifiedResnet('resnet50') "
              f"({len(written)} keys), its forward on the card finite; "
              f"phase {time.perf_counter() - t0:.1f} s")


def _labels(path):
    import pickle
    with open(path, "rb") as f:
        return pickle.load(f)


def phase_data_prep(device) -> None:
    """Phase 30: ``data/synthetic.py::build_raw_prep_tree`` in a temporary
    directory, the four stages of ``cli/data_processing.py`` with the
    RANSAC on the card and, on a copy, on the CPU: image lists equal as
    text, Real-train and test labels equal, CAMERA-train labels within
    PREP_RANSAC_TOL (other draws, the same all-inlier refit); each stage's
    wall time; at each of RANSAC_POINTS, the RANSAC's ms and peak memory
    on the card and ``estimate_similarity_transform``'s ms on the card
    and on the CPU."""
    import glob
    import shutil
    import tempfile

    import numpy as np
    import torch

    from istnet_tpu_torch.cli import data_processing as dp
    from istnet_tpu_torch.data import synthetic
    from istnet_tpu_torch.ops.umeyama import (
        estimate_similarity_transform, ransac_similarity)
    with tempfile.TemporaryDirectory() as root:
        raw = os.path.join(root, "raw")
        synthetic.build_raw_prep_tree(raw)
        runs = {}
        for tag, where in (("card", str(device)), ("cpu", "cpu")):
            tree = os.path.join(root, tag)
            shutil.copytree(raw, tree)
            stages = {}
            for name, fn in (
                    ("create_img_list", lambda: dp.create_img_list(tree)),
                    ("annotate_camera_train",
                     lambda: dp.annotate_camera_train(tree, where)),
                    ("annotate_real_train", lambda: dp.annotate_real_train(tree)),
                    ("annotate_test_data", lambda: dp.annotate_test_data(tree))):
                t0 = time.perf_counter()
                fn()
                stages[name] = time.perf_counter() - t0
            runs[tag] = tree, stages
        (card, card_s), (cpu, cpu_s) = runs.values()
        for rel in ("CAMERA/train_list_all.txt", "CAMERA/val_list_all.txt",
                    "Real/train_list_all.txt", "Real/test_list_all.txt",
                    "CAMERA/train_list.txt", "Real/train_list.txt",
                    "CAMERA/val_list.txt", "Real/test_list.txt"):
            with open(os.path.join(card, rel)) as a, \
                    open(os.path.join(cpu, rel)) as b:
                if a.read() != b.read():
                    raise AssertionError(f"data prep: {rel} differs")
        worst = 0.0
        labels = sorted(glob.glob(os.path.join(card, "**", "*_label.pkl"),
                                  recursive=True))
        for path in labels:
            rel = os.path.relpath(path, card)
            a, b = _labels(path), _labels(os.path.join(cpu, rel))
            if set(a) != set(b):
                raise AssertionError(f"data prep: {rel} keys differ")
            for key, bv in b.items():
                if rel.startswith("CAMERA/train") and key in (
                        "scales", "rotations", "translations"):
                    err = float(np.abs(a[key] - bv).max())
                    worst = max(worst, err)
                    if err > PREP_RANSAC_TOL:
                        raise AssertionError(f"data prep: {rel} {key} card "
                                             f"vs CPU {err}")
                elif not np.array_equal(np.asarray(a[key]), np.asarray(bv)):
                    raise AssertionError(f"data prep: {rel} {key} differs")
        fmt = ", ".join
        print(f"[data prep] {len(labels)} label files; lists equal, Real and "
              f"test labels equal, CAMERA-train card vs CPU max abs err "
              f"{worst:.3g} (bound {PREP_RANSAC_TOL:g}); stages on "
              f"{device}: {fmt(f'{k} {v:.2f} s' for k, v in card_s.items())}; "
              f"on the CPU: {fmt(f'{k} {v:.2f} s' for k, v in cpu_s.items())}")
    # the RANSAC alone, an instance of the synthetic tree's size and of
    # real NOCS mask sizes: on the card by CUDA events with its peak memory,
    # and the stage's per-instance fit (numpy in and out) on the card and
    # on the CPU, each after a warmup
    for n in RANSAC_POINTS:
        src = np.random.RandomState(30).rand(n, 3).astype(np.float32)
        tgt = src * np.float32(400.0) + np.float32(800.0)
        s_t, t_t = (torch.from_numpy(a).to(device) for a in (src, tgt))
        gen = torch.Generator(device=device).manual_seed(0)
        ransac_similarity(s_t, t_t, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        ransac_ms = cuda_ms(lambda: ransac_similarity(s_t, t_t, gen), iters=5)
        peak = (torch.cuda.max_memory_allocated(device) - base) / 2 ** 20
        del s_t, t_t
        fits, per_call = {}, {}
        for where in (str(device), "cpu"):
            fits[where] = estimate_similarity_transform(src, tgt,
                                                        device=where)
            per_call[where] = timed(estimate_similarity_transform, src, tgt,
                                    iters=3, warmup=0, device=where) * 1e3
            if fits[where][0] is None or not np.isfinite(fits[where][3]).all():
                raise AssertionError(f"data prep: the RANSAC of {n} points "
                                     f"on {where} gave no fit")
        gap = float(np.abs(fits[str(device)][3] - fits["cpu"][3]).max())
        print(f"[data prep] RANSAC (128 hypotheses) of a {n}-point instance: "
              f"{ransac_ms:.3f} ms on the card, peak +{peak:.1f} MiB; "
              f"estimate_similarity_transform {per_call[str(device)]:.3f} ms "
              f"on the card, {per_call['cpu']:.3f} ms on the CPU "
              f"({torch.get_num_threads()} threads); card vs CPU transform "
              f"max abs diff {gap:.3g}")
        torch.cuda.empty_cache()


def phase_vis(model, device) -> None:
    """Phase 31: ``cli/test.py --vis --vis_axes --vis_labels`` on the card
    over phase 14's kind of tree, from the f32 model's weights: one PNG a
    non-empty frame (at most 50), each pixel-equal to ``draw_detections``
    run on the CPU from the same result pickle."""
    import glob
    import logging
    import tempfile

    import cv2
    import numpy as np
    import torch

    from istnet_tpu_torch.cli import test as cli_test
    from istnet_tpu_torch.data import synthetic
    from istnet_tpu_torch.data.dataset import REAL_INTRINSICS
    from istnet_tpu_torch.eval.vis import draw_detections
    quiet = logging.getLogger("istnet")
    with tempfile.TemporaryDirectory() as root:
        synthetic.build_test_tree(root, LOOP_FRAMES, LOOP_INSTANCES)
        weights = os.path.join(root, "w.pth")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   weights)
        cfg = _config_copy(root, "ist_net_default.yaml")
        log_dir = os.path.join(root, "log")
        t0 = time.perf_counter()
        level = quiet.level
        quiet.setLevel(logging.ERROR)
        try:
            iou, pose = cli_test.main(["--config", cfg, "--data_dir", root,
                                       "--torch_checkpoint", weights,
                                       "--log_dir", log_dir, "--device",
                                       str(device), "--vis", "--vis_axes",
                                       "--vis_labels"])
        finally:
            quiet.setLevel(level)
        seconds = time.perf_counter() - t0
        if not (np.isfinite(iou).all() and np.isfinite(pose).all()):
            raise AssertionError("vis: non-finite APs")
        save = os.path.join(log_dir, "eval_epoch30")
        pkls = sorted(glob.glob(os.path.join(save, "*.pkl")))
        fx, fy, cx, cy = REAL_INTRINSICS
        k = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        drawn = 0
        for i, path in enumerate(pkls[:50]):
            r = _labels(path)
            png = os.path.join(save, "vis", f"real_{i}_pred.png")
            # results_test_<scene>_<stem>.pkl; no frame of the tree is empty
            scene, stem = os.path.basename(path)[len("results_test_"):-4
                                                 ].rsplit("_", 1)
            img = cv2.imread(os.path.join(root, "data", "Real", "test",
                                          scene, f"{stem}_color.png"))
            want = draw_detections(img, os.path.join(root, "cpu_vis"), "real",
                                   i, k, r["pred_RTs"], r["pred_scales"],
                                   r["pred_class_ids"], r["gt_RTs"],
                                   r["gt_scales"], r["gt_class_ids"],
                                   draw_axes=True, draw_labels=True)
            if not np.array_equal(cv2.imread(png), want):
                raise AssertionError(f"vis: {png} differs from the CPU's")
            drawn += 1
        pngs = os.listdir(os.path.join(save, "vis"))
        if not drawn == len(pngs) == min(50, LOOP_FRAMES) == len(pkls):
            raise AssertionError(f"vis: {len(pngs)} PNGs over {len(pkls)} "
                                 f"frames")
    print(f"[vis] cli/test.py --vis --vis_axes --vis_labels on {device}: "
          f"{drawn} PNGs over {len(pkls)} frames, each pixel-equal to the "
          f"CPU's draw_detections of its result pickle; finite APs; "
          f"{seconds:.1f} s with the loop")


def phase_profiling(model, device) -> None:
    """Phase 32: ``utils/profiling.trace`` around PROFILED_FORWARDS B=32 f32
    eval forwards (each in a ``record_function``), then ``parse_trace``
    and ``aggregate_ops``: in the last forward, each kernel's device rows
    (``TRACE_KERNELS``) as many as its wrapper's launches a forward; then
    ``timed`` against ``cuda_ms`` on the forward, five rounds each."""
    import statistics
    import tempfile

    import torch

    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_inputs
    from istnet_tpu_torch.utils import profiling
    inp = make_inputs(BATCH, seed=32, device=device)
    with torch.inference_mode():
        model(inp)
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            ops.reset_launch_counts()
            with profiling.trace(d):
                for i in range(PROFILED_FORWARDS):
                    with torch.profiler.record_function(f"forward {i}"):
                        model(inp)
                    torch.cuda.synchronize()
            counts = ops.launch_counts()
            rows = profiling.parse_trace(d)
    last = f"forward {PROFILED_FORWARDS - 1}"
    # the scope runs from the outermost block: the forward's, then the
    # program's spans inside it (utils/tracing.py)
    mine = [r for r in rows if r["scope"].split("/")[0] == last]
    seen = {name: sum(bool(re.search(pattern, r["name"])) for r in mine)
            for name, pattern in TRACE_KERNELS.items()}
    want = {name: counts[name] // PROFILED_FORWARDS for name in TRACE_KERNELS}
    if seen != want or want != {k: F32_PER_FORWARD[k] for k in want}:
        raise AssertionError(f"profiling: kernels in the trace {seen}, "
                             f"wrapper launches a forward {want}")
    top = profiling.aggregate_ops(rows, key="op", top=6,
                                  calls=PROFILED_FORWARDS)
    print(f"[profiling] {len(rows)} device rows over {PROFILED_FORWARDS} "
          f"forwards; the last forward's port kernels in the trace {seen}, "
          f"as their wrappers' launches; device us a forward by op, top 6: "
          + ", ".join(f"{a['key'][:40]} {a['dur_us']} ({a['n']})"
                      for a in top))
    with torch.inference_mode():
        ev, wall = [], []
        for _ in range(5):
            ev.append(cuda_ms(lambda: model(inp), iters=5))
            wall.append(profiling.timed(model, inp, iters=5) * 1e3)
    spread = max(max(ev) - min(ev), max(wall) - min(wall))
    gap = statistics.median(wall) - statistics.median(ev)
    print(f"[profiling] B={BATCH} forward: timed {statistics.median(wall):.3f}"
          f" ms (min {min(wall):.3f}, max {max(wall):.3f}), cuda_ms "
          f"{statistics.median(ev):.3f} (min {min(ev):.3f}, max "
          f"{max(ev):.3f}); medians {gap:+.3f} ms apart, spread "
          f"{spread:.3f} ms")
    if abs(gap) > spread:
        raise AssertionError(f"profiling: timed and cuda_ms {gap:.3f} ms "
                             f"apart, beyond the spread {spread:.3f}")


def phase_training(device, bare: float):
    """Phases 15-18, 22 and 26 in one temporary directory: the synthetic
    train trees (LOOP_SCENES scenes each) and a test tree, then the loop,
    the resume, the two-phase recipe, the 2048-point config from the
    two-phase recipe's PoseNetGT checkpoint, the device loop and the loop
    under torchrun; returns the loop's, PoseNetGT's, the 2048-point
    config's, the device loop's and the torchrun loop's launches and
    kernel 11's case on the device loop's path."""
    import tempfile

    import torch

    from istnet_tpu_torch.data import synthetic
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        synthetic.build_train_trees(os.path.join(root, "data"), LOOP_SCENES)
        synthetic.build_test_tree(root, LOOP_TEST_FRAMES)
        print(f"[train loop] wrote Real + CAMERA train trees of "
              f"{LOOP_SCENES} scenes and {LOOP_TEST_FRAMES} test frames in "
              f"{time.perf_counter() - t0:.1f} s")
        loop_counts, trained = phase_train_loop(root, device, bare)
        phase_resume(root, device, trained)
        p1_counts = phase_two_phase(root, device)
        # the config's CLI sets bf16; restored after
        with policy(torch.float32):
            counts_2048 = phase_2048_config(root, device)
        device_counts, fill_case = phase_device_loop(root, device, trained)
        del trained
        torchrun_counts = phase_torchrun_cli(root, device)
    return (loop_counts, p1_counts, counts_2048, device_counts, fill_case,
            torchrun_counts)


BENCH_BATCH = 128
BENCH_ROUNDS, BENCH_ITERS = 2, 3          # a round: BENCH_ITERS calls
BENCH_TRAIN_ITERS = 2
BENCH_EVAL_IMAGES = 64
# rows 0..31 of the B=128 forward against the B=32 forward of those rows:
# phase 5's bounds under each policy
BENCH_ROW_TOL = {"float32": CPU_ATOL, "bfloat16": BF16_CPU_ATOL}
# every kernel the bench's paths launch: the eval forward's (1-5, 5 under
# bf16 only, and the eval BN pass), the train step's backward (8, 10, the scatters) and the
# device pipeline's fill (11)
BENCH_KERNELS = ("fps", "ball_query_group", "fp_interpolate", "fold_upsample",
                 "sa_fused", "ball_query", "group_scatter", "three_nn",
                 "interp_scatter", "depth_fill", "bn_eval")


def phase_bench(device, models: dict) -> tuple:
    """Phase 36: the bench's path (``bench_torch.py``, ``tools/
    {train,eval}_bench_torch.py``) on the card, at few rounds. Kernels 1-5
    against their plain versions at B=128 under both policies (the bench's
    new shapes) and timed there; then ``bench_torch.measure`` (both
    policies at B=32 and 128, the train steps) between the launch counts'
    reset and read: every rate finite and above 0, the record carrying
    ``bench.py``'s keys, every kernel of ``BENCH_KERNELS`` launched; the
    bench's B=32 forward under each policy bit-equal to ``models``' (phases
    4's) on the same seed; rows 0-31 of the B=128 forward within
    ``BENCH_ROW_TOL`` of the B=32 forward of those rows; the eval loops of
    ``tools/eval_bench_torch.py`` over BENCH_EVAL_IMAGES images in all
    three modes, every pkl's poses finite. Returns the launches and, per
    policy, the B=128 kernel cases' errors and times."""
    import math
    import pickle
    import tempfile

    import numpy as np
    import torch

    import bench_torch
    import eval_bench_torch
    from istnet_tpu_torch import ops
    from istnet_tpu_torch.entry import make_inputs
    errs, times = {}, {}
    with policy(torch.float32):
        cases = {name: [(args, True) for args in arg_list] for name, arg_list
                 in kernel_cases(device, BENCH_BATCH).items()}
        errs["float32"] = phase_kernels(cases, tag=f"bench B={BENCH_BATCH} ")
        times["float32"] = time_kernels(cases, f"bench B={BENCH_BATCH} ")
    with policy(torch.bfloat16):
        cases = {name: case_list[:len(case_list) - (name == "sa_fused")]
                 for name, case_list
                 in kernel_cases_bf16(device, BENCH_BATCH).items()}
        errs["bfloat16"] = phase_kernels(cases, bf16=True,
                                         tag=f"bench B={BENCH_BATCH} ")
        times["bfloat16"] = time_kernels(cases,
                                         f"bench B={BENCH_BATCH} bf16 ")

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    m = bench_torch.measure(BENCH_ROUNDS, BENCH_ITERS, BENCH_ROUNDS,
                            BENCH_TRAIN_ITERS, device)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    record = bench_torch.make_record(m, bench_torch.card_name_and_limit())
    print(f"[bench] record: {json.dumps(record)}")
    bad = [r for r in bench_torch.rates(record)
           if not (math.isfinite(r) and r > 0)]
    missing = {"metric", "value", "unit", "vs_baseline", "batch", "b32_value",
               "b128_value", "train_steps_per_sec", "train_samples_per_sec",
               "train_batch"} - set(record)
    unlaunched = [k for k in BENCH_KERNELS if not counts[k]]
    print(f"[bench] launches over the bench's run: {counts}")
    if bad or missing or unlaunched:
        raise AssertionError(f"bench: rates {bad}, keys missing {missing}, "
                             f"kernels not launched {unlaunched}")
    for key in sorted(k for k in record if k.startswith("forward_")):
        r = record[key]
        print(f"[bench] {key}: {r['inf_per_s']:.1f} inf/s ({r['ms']:.3f} ms, "
              f"rounds {r['ms_min']:.3f}-{r['ms_max']:.3f}), peak "
              f"{r['peak_gib']:.2f} GiB, busy {r['busy_share']:.1%}")

    for dtype, model in models.items():
        label = str(dtype).removeprefix("torch.")
        fn, _, _ = bench_torch.forward_case(dtype, BATCH, device)
        got = fn()
        with policy(dtype), torch.inference_mode():
            want = model(make_inputs(BATCH, seed=0, device=device))
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        fn128, bench_model, inp = bench_torch.forward_case(
            dtype, BENCH_BATCH, device)
        out128 = fn128()
        with policy(dtype), torch.inference_mode():
            out32 = bench_model({k: v[:BATCH] for k, v in inp.items()})
        rows = max((out128[k][:BATCH].float() - v.float()).abs().max().item()
                   for k, v in out32.items())
        print(f"[bench] {label}: the bench's B={BATCH} forward against phase "
              f"4's model on seed 0: {'bit-equal' if not differ else differ}"
              f"; rows 0-{BATCH - 1} of B={BENCH_BATCH} against B={BATCH} "
              f"of those rows: max abs {rows:.3g} (bound "
              f"{BENCH_ROW_TOL[label]})")
        if differ or not rows <= BENCH_ROW_TOL[label]:
            raise AssertionError(f"bench {label}: outputs {differ} differ "
                                 f"from phase 4's; B={BENCH_BATCH} rows "
                                 f"{rows}")
        del bench_model, fn128, out128

    with tempfile.TemporaryDirectory() as work:
        res = eval_bench_torch.run(eval_bench_torch.MODES, BENCH_EVAL_IMAGES,
                                   64, device, work)
        for mode in eval_bench_torch.MODES:
            save = os.path.join(work, "res_" + mode)
            for name in os.listdir(save):
                with open(os.path.join(save, name), "rb") as f:
                    rts = pickle.load(f)["pred_RTs"]
                if not np.isfinite(rts).all():
                    raise AssertionError(f"eval bench {mode}: {name} holds "
                                         f"non-finite poses")
    print(f"[bench] eval loops over {BENCH_EVAL_IMAGES} images: "
          + ", ".join(f"{k} {v:.2f}" for k, v in res.items()
                      if k.endswith("per_sec"))
          + " images/s; every pkl's poses finite")
    return counts, errs, times


# the native host depth fill (phase 37): tests/test_native_core.py's bound
# on the core against OpenCV, here also against kernel 11; host ms a frame
# as the median of HOST_FILL_ROUNDS calls after one warmup
HOST_FILL_TOL_MM = 0.01
HOST_FILL_ROUNDS = 10
HALF_HOLES = 0.5


def _cpu_model() -> str:
    """``lscpu``'s model name, or its vendor, family and model numbers
    where it names no model."""
    fields = {}
    for line in run(["lscpu"]).splitlines():
        key, _, value = line.partition(":")
        fields.setdefault(key.strip(), value.strip())
    name = fields.get("Model name", "unknown")
    if name != "unknown":
        return name
    return (f"{fields.get('Vendor ID', '?')} family "
            f"{fields.get('CPU family', '?')} model {fields.get('Model', '?')}"
            f" (lscpu names no model)")


def _median_ms(fn, rounds: int = HOST_FILL_ROUNDS) -> float:
    fn()
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[rounds // 2]


def phase_native_fill(device) -> None:
    """Phase 37: the port's native host fill (``istnet_tpu_torch/native``,
    built by ``phase_build``) on the serving frame and on a 480 x 640 frame
    with HALF_HOLES of its pixels empty: against the OpenCV chain
    (``fill_missing(prefer_native=False)``) and kernel 11 within
    HOST_FILL_TOL_MM, the default ``fill_missing`` bit-equal to the native
    call; host ms a frame of the native and the OpenCV fill beside the
    CPU's model and the card's name and power limit."""
    import numpy as np
    import torch

    from istnet_tpu_torch import native
    from istnet_tpu_torch.data import depth_utils
    from istnet_tpu_torch.data.device_preprocess import fill_missing
    from istnet_tpu_torch.entry import make_frame
    info = native.build_info
    print(f"[native fill] {native.LIB_NAME} built in "
          f"{info.get('seconds', 0.0):.2f} s (cached {info.get('cached')}) by "
          f"{info.get('compiler')}, flags {' '.join(native.CXXFLAGS)}")
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    cpu = _cpu_model()
    frames = {"the serving frame": _serve_frame(device)[1],
              "a half-empty frame": make_frame(
                  37, SERVE_INSTANCES, hole_share=HALF_HOLES)["depth_raw"]}
    for label, mm in frames.items():
        empty = float((mm <= 0).mean())
        nat = native.fill_missing_native(mm, 1000.0, 1.0)
        default = depth_utils.fill_missing(mm, 1000.0, 1.0)
        opencv = depth_utils.fill_missing(mm, 1000.0, 1.0,
                                          prefer_native=False)
        kern = fill_missing(torch.from_numpy(mm)[None].to(device))[0]
        kern = kern.cpu().numpy()
        err_cv = float(np.abs(nat - opencv).max())
        err_k = float(np.abs(nat - kern).max())
        if not np.array_equal(default, nat):
            raise AssertionError(f"native fill, {label}: the default "
                                 f"fill_missing is not the native call")
        if not (err_cv <= HOST_FILL_TOL_MM and err_k <= HOST_FILL_TOL_MM):
            raise AssertionError(
                f"native fill, {label}: {err_cv} mm off OpenCV, {err_k} mm "
                f"off kernel 11 (bound {HOST_FILL_TOL_MM})")
        nat_ms = _median_ms(lambda: native.fill_missing_native(mm, 1000.0,
                                                               1.0))
        cv_ms = _median_ms(lambda: depth_utils.fill_missing(
            mm, 1000.0, 1.0, prefer_native=False))
        print(f"[native fill] {label} ({mm.shape[0]}x{mm.shape[1]}, "
              f"{empty:.1%} empty): the default fill_missing bit-equal to "
              f"the native call; native against OpenCV max abs err "
              f"{err_cv:.3g} mm, against kernel 11 {err_k:.3g} mm (bound "
              f"{HOST_FILL_TOL_MM:g}); host ms a frame, median of "
              f"{HOST_FILL_ROUNDS} after 1 warmup: native {nat_ms:.3f}, "
              f"OpenCV {cv_ms:.3f} ({cv_ms / nat_ms:.2f}x); CPU {cpu} "
              f"(os.cpu_count() {os.cpu_count()}); card {card}")


# the checkpoint converter (phase 38): .pth -> .npz -> .pth at full width
CONVERT_CASES = ("ist_net", "posenet_gt", "frozen")


def _convert_model(case: str, device, seed: int):
    """A full-width eval model of ``case`` on ``device``, random weights
    and perturbed BN statistics from ``seed``."""
    import torch

    from istnet_tpu_torch.entry import (build_model, init_weights_,
                                        perturb_eval_stats_)
    from istnet_tpu_torch.models.posenet_gt import PoseNetGT
    if case != "posenet_gt":
        return build_model(device, seed=seed,
                           freeze_world_enhancer=case == "frozen")
    model = PoseNetGT()
    init_weights_(model, torch.Generator().manual_seed(seed))
    perturb_eval_stats_(model, seed)
    return model.eval().to(device)


def phase_convert(device) -> dict:
    """Phase 38: ``cli/convert_torch_istnet.py`` both ways at full width.
    Per case (``ISTNet``, ``PoseNetGT``, a frozen ``ISTNet`` checkpoint
    without ``world_enhancer.pose_estimator``): the state dict (its dead
    ``feats.fc`` zeroed, as the ``.npz`` carries none) saved as ``.pth``,
    ``--torch_ckpt`` to ``.npz``, ``--export_npz`` back to ``.pth``: the
    export equal to the original key for key and bit for bit; the B=32 eval
    forward on the card from the ``.npz`` (``convert.load_weights``) and
    from the exported ``.pth`` bit-equal to the original weights' forward.
    Returns the launches of the ISTNet forward from the ``.npz``."""
    import tempfile

    import torch

    from istnet_tpu_torch import convert, ops
    from istnet_tpu_torch.cli import convert_torch_istnet
    from istnet_tpu_torch.entry import make_inputs, make_train_batch
    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, case in enumerate(CONVERT_CASES):
            kind = "posenet_gt" if case == "posenet_gt" else "ist_net"
            src = _convert_model(case, device, seed=i)
            with torch.no_grad():
                for k, v in src.state_dict().items():
                    if ".feats.fc." in k:
                        v.zero_()
            sd = {k: v.detach().cpu().clone()
                  for k, v in src.state_dict().items()
                  if not (case == "frozen"
                          and k.startswith("world_enhancer.pose_estimator."))}
            pth = os.path.join(tmp, f"{case}.pth")
            torch.save(sd, pth)
            t0 = time.perf_counter()
            npz = convert_torch_istnet.main(["--torch_ckpt", pth,
                                             "--model", kind])
            t1 = time.perf_counter()
            back = convert_torch_istnet.main(["--export_npz", npz,
                                              "--model", kind])
            t2 = time.perf_counter()
            exported = torch.load(back, weights_only=True)
            off = sorted(set(sd) ^ set(exported)) + [
                k for k in sd if k in exported
                and not (exported[k].dtype == sd[k].dtype
                         and torch.equal(exported[k], sd[k]))]
            if off:
                raise AssertionError(f"convert {case}: {len(off)} keys of the "
                                     f"export off the original: {off[:5]}")
            if case == "posenet_gt":
                inputs = make_train_batch(BATCH, seed=38,
                                          device=device)["inputs"]
            else:
                inputs = make_inputs(BATCH, seed=38, device=device)
            outs = {}
            for label, state in (("npz", convert.load_weights(npz, kind)),
                                 ("pth", exported)):
                model = _convert_model(case, device, seed=10 + i)
                if case == "frozen":
                    own = model.state_dict()
                    state = {**{k: v for k, v in own.items()
                                if k.startswith(
                                    "world_enhancer.pose_estimator.")},
                             **state}
                model.load_state_dict(state, strict=True)
                with torch.inference_mode():
                    torch.cuda.synchronize()
                    ops.reset_launch_counts()
                    outs[label] = model(inputs)
                    torch.cuda.synchronize()
                    if case == "ist_net" and label == "npz":
                        counts = ops.launch_counts()
            with torch.inference_mode():
                want = src(inputs)
            differ = [f"{label}:{k}" for label, out in outs.items()
                      for k in want if not torch.equal(out[k], want[k])]
            for out in outs.values():
                for k, v in out.items():
                    if not torch.isfinite(v).all():
                        raise AssertionError(f"convert {case}: {k} not finite")
            print(f"[convert] {case}: {len(sd)} tensors -> "
                  f"{os.path.getsize(npz) / 2 ** 20:.1f} MiB .npz in "
                  f"{t1 - t0:.2f} s -> .pth in {t2 - t1:.2f} s, the export "
                  f"equal to the original key for key and bit for bit; the "
                  f"B={BATCH} eval forward from the .npz and from the export: "
                  f"{len(differ)} of {2 * len(want)} outputs off the "
                  f"original weights' forward in any bit")
            if differ:
                raise AssertionError(f"convert {case}: {differ[:4]}")
    if {k: v for k, v in counts.items() if v} != {
            k: v for k, v in F32_PER_FORWARD.items() if v}:
        raise AssertionError(f"convert: launches {counts}, expected "
                             f"{F32_PER_FORWARD}")
    print(f"[convert] the ist_net forward from the .npz: launches {counts}")
    return counts


def main() -> int:
    device_info = phase_device()
    import torch

    from istnet_tpu_torch.entry import build_model, build_serving_model
    from istnet_tpu_torch.ops import dispatch
    phase_build()
    device = torch.device("cuda", 0)
    kernels = []

    def record(path, dtype, errs, counts, times, names):
        for name in names:
            mod = dispatch.KERNELS[name]
            k_ms, p_ms, least, bound_by, l_ms = times[name]
            # library_ms: LIBRARY_CALLS' call where there is one, null
            # elsewhere (library_call says why)
            kernels.append({"name": name, "path": path, "dtype": dtype,
                            "route": "cuda", "source": mod.SOURCE,
                            "replaces": mod.REPLACES, "launches": counts[name],
                            "max_abs_err": errs[name], "ms": k_ms,
                            "plain_ms": p_ms, "bound_ms": least,
                            "bound_by": bound_by, "library_ms": l_ms})

    def record_split(path, errs, counts, times, cases):
        # under bf16 the geometry's kernels read float32 points; the
        # grouping, the interpolation and the scatters carry bf16
        geometry = [n for n in cases if n in ("fps", "ball_query", "three_nn")]
        record(path, "float32", errs, counts, times, geometry)
        record(path, "bfloat16", errs, counts, times,
               [n for n in cases if n not in geometry])

    with policy(torch.float32):
        cases = {name: [(args, True) for args in arg_list]
                 for name, arg_list in kernel_cases(device).items()}
        errs = phase_kernels(cases)
        model = build_model(device)
        counts = phase_forward(model, device, F32_PER_FORWARD)
        phase_reference(model, device)
        times = phase_timings(model, cases, device)
    record("float32", "float32", errs, counts, times, list(cases))

    with policy(torch.float32):
        fill_cases = phase_depth_fill(device)
        serve = {**{name: [(args, True) for args in arg_list] for name, arg_list
                    in kernel_cases(device, SERVE_BUCKET).items()},
                 **fill_cases}
        errs_s = phase_kernels(serve, tag="serve ")
        counts_s, serve_model = phase_device_forward(
            torch.float32, device, F32_PER_FORWARD)
        phase_device_reference(device)
        phase_loops(serve_model, device)
        times_s = time_kernels(serve, "serve ")
    record("serve float32", "float32", errs_s, counts_s, times_s, list(serve))

    with policy(torch.bfloat16):
        cases16 = kernel_cases_bf16(device)
        errs16 = phase_kernels(cases16, bf16=True)
        model16 = build_serving_model(torch.bfloat16, device)
        counts16 = phase_forward(model16, device, BF16_PER_FORWARD, "bf16 ")
        phase_reference(model16, device, BF16_CPU_ATOL, "bf16 ")
        phase_drift(model16, device)
        times16 = phase_timings(model16, cases16, device, "bf16 ")
        phase_stage1_choice(model16, device)
    # FPS runs on the float32 geometry under both policies
    errs16["fps"], times16["fps"] = errs["fps"], times["fps"]
    record("bfloat16", "float32", errs16, counts16, times16, ["fps"])
    record("bfloat16", "bfloat16", errs16, counts16, times16, list(cases16))

    with policy(torch.bfloat16):
        serve16 = {name: case_list[:len(case_list) - (name == "sa_fused")]
                   for name, case_list
                   in kernel_cases_bf16(device, SERVE_BUCKET).items()}
        errs_s16 = phase_kernels(serve16, bf16=True, tag="serve ")
        counts_s16, _ = phase_device_forward(
            torch.bfloat16, device, BF16_PER_FORWARD, "bf16 ")
        times_s16 = time_kernels(serve16, "serve bf16 ")
    # the fill and FPS run on float32 data under both policies
    for name in ("depth_fill", "fps"):
        errs_s16[name], times_s16[name] = errs_s[name], times_s[name]
    record("serve bfloat16", "float32", errs_s16, counts_s16, times_s16,
           ["depth_fill", "fps"])
    record("serve bfloat16", "bfloat16", errs_s16, counts_s16, times_s16,
           list(serve16))

    with policy(torch.float32):
        train_cases = with_three_nn_distances(
            with_bf16_scatter_twins(train_kernel_cases(device)))
        errs_t = phase_kernels(train_cases, tag="train ")
        phase_bf16_backward(device)
        times_t = time_kernels(train_cases, "train ")
        counts_t = phase_train_steps(device)
        phase_train_reference(device)
        phase_train_full_width(device)
        bare = phase_train_timings(device)
        phase_train_timings(device, frozen=True)
    record("train", "float32", errs_t, counts_t, times_t, list(train_cases))

    # phase 19: the bf16 train policy at N = 1024
    with policy(torch.bfloat16):
        cases_tb = train_kernel_cases(device, bf16=True)
        errs_tb = phase_kernels(cases_tb, bf16=True, tag="train ")
        phase_gather_backward(device)
        times_tb = time_kernels(cases_tb, "train bf16 ")
        counts_tb = phase_train_steps(device, torch.bfloat16, tag="bf16 ")
        phase_train_full_width(device, torch.bfloat16)
        phase_train_timings(device, dtype=torch.bfloat16)
        phase_train_timings(device, frozen=True, dtype=torch.bfloat16)
    record_split("train bf16", errs_tb, counts_tb, times_tb, cases_tb)

    # phases 20-21: N = 2048, the eval forward under both policies, then
    # the frozen bf16 step and the train sampler
    with policy(torch.float32):
        cases_e2 = kernel_cases(device, points=2048)
        cases_e2 = {name: [(args, True) for args in arg_list]
                    for name, arg_list in cases_e2.items()}
        errs_e2 = phase_kernels(cases_e2, tag="eval 2048 ")
        counts_e2 = phase_eval_2048(model, device, F32_PER_FORWARD, CPU_ATOL,
                                    "2048 ")
        times_e2 = time_kernels(cases_e2, "eval 2048 ")
    record("eval 2048", "float32", errs_e2, counts_e2, times_e2,
           list(cases_e2))
    with policy(torch.bfloat16):
        cases_e2b = {name: case_list[:len(case_list) - (name == "sa_fused")]
                     for name, case_list
                     in kernel_cases_bf16(device, points=2048).items()}
        errs_e2b = phase_kernels(cases_e2b, bf16=True, tag="eval 2048 ")
        counts_e2b = phase_eval_2048(model16, device, BF16_PER_FORWARD,
                                     BF16_CPU_ATOL, "bf16 2048 ")
        times_e2b = time_kernels(cases_e2b, "eval 2048 bf16 ")
    # FPS at SA 1 (2048 -> 512) is the float32 path's case
    errs_e2b["fps"], times_e2b["fps"] = errs_e2["fps"], times_e2["fps"]
    record("eval 2048 bf16", "float32", errs_e2b, counts_e2b, times_e2b,
           ["fps"])
    record("eval 2048 bf16", "bfloat16", errs_e2b, counts_e2b, times_e2b,
           list(cases_e2b))
    with policy(torch.bfloat16):
        cases_t2 = train_kernel_cases(device, points=2048, bf16=True,
                                      frozen=True)
        errs_t2 = phase_kernels(cases_t2, bf16=True, tag="train 2048 ")
        times_t2 = time_kernels(cases_t2, "train bf16 2048 ")
        phase_train_steps(device, torch.bfloat16, points=2048,
                          recipes=("frozen",), tag="bf16 2048 ")
        phase_train_timings(device, frozen=True, dtype=torch.bfloat16,
                            points=2048)
        phase_sampler_2048(device)

    (loop_counts, posenet_counts, counts_2048, device_counts, fill_case,
     torchrun_counts) = phase_training(device, bare)
    record_split("train bf16 2048", errs_t2, counts_2048, times_t2, cases_t2)
    record("train loop", "float32", errs_t, loop_counts, times_t,
           list(train_cases))
    record("posenet_gt", "float32", errs_t, posenet_counts, times_t,
           list(train_cases))
    with policy(torch.float32):
        errs_d = {**errs_t, **phase_kernels(fill_case, tag="device loop ")}
        times_d = {**times_t, **time_kernels(fill_case, "device loop ")}
    record("device loop", "float32", errs_d, device_counts, times_d,
           ["depth_fill", *train_cases])
    record("torchrun loop", "float32", errs_t, torchrun_counts, times_t,
           list(train_cases))

    # phases 23-25, 27: FPS past 2048 points, DDP over NCCL at world 1,
    # two gloo ranks on the card, the data-parallel eval forward (its
    # replicas run B = 16: the eval kernels at those shapes)
    with policy(torch.float32):
        phase_fps_large(device)
        ddp_counts = phase_ddp_world1(device)
        phase_two_ranks_one_card(device)
        cases_dp = {name: [(args, True) for args in arg_list]
                    for name, arg_list
                    in kernel_cases(device, BATCH // 2).items()}
        errs_dp = phase_kernels(cases_dp, tag="eval dp ")
        dp_counts = phase_eval_dp(model, device)
        times_dp = time_kernels(cases_dp, "eval dp ")
    record("ddp world 1", "float32", errs_t, ddp_counts, times_t,
           list(train_cases))
    record("eval dp", "float32", errs_dp, dp_counts, times_dp, list(cases_dp))

    # phases 28-32: the trunk backends (the fold at the eval shape of
    # phases 3 and 6 under each policy), the ImageNet trunk, data
    # preparation, --vis and the profiling helpers
    seconds = {}

    def clocked(label, phase, *args):
        t0 = time.perf_counter()
        with policy(torch.float32):
            out = phase(*args)
        seconds[label] = time.perf_counter() - t0
        return out

    trunk_runs = clocked("28 trunks", phase_trunks, device)
    clocked("29 pretrained backbone", phase_pretrained_backbone, device)
    clocked("30 data prep", phase_data_prep, device)
    clocked("31 vis", phase_vis, model, device)
    clocked("32 profiling", phase_profiling, model, device)
    print("[phases 28-32] " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in seconds.items())
          + f"; {sum(seconds.values()):.1f} s in all")
    for path, dtype in (("trunks", "float32"), ("trunks bf16", "bfloat16")):
        counts_k, errs_k, times_k = trunk_runs[dtype]
        record(path, dtype, errs_k, counts_k, times_k, ["fold_upsample"])

    # phases 33-35: FSDP at world 1 over NCCL against the plain step, the
    # sharded checkpoint, two gloo ranks sharding the model on the card
    seconds = {}
    fsdp_counts = clocked("33-34 fsdp world 1, sharded checkpoint",
                          phase_fsdp_world1, device)
    clocked("35 fsdp two ranks", phase_two_ranks_one_card, device, True)
    print("[phases 33-35] " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in seconds.items()))
    record("fsdp world 1", "float32", errs_t, fsdp_counts["float32"],
           times_t, list(train_cases))
    record_split("fsdp world 1 bf16", errs_tb, fsdp_counts["bfloat16"],
                 times_tb, cases_tb)

    # phase 36: the bench's path, kernels 1-5 at its B=128 shapes
    seconds = {}
    bench_counts, errs_b, times_b = clocked(
        "36 bench", phase_bench, device,
        {torch.float32: model, torch.bfloat16: model16})
    print(f"[phase 36] {seconds['36 bench']:.1f} s")
    record(f"bench B={BENCH_BATCH}", "float32", errs_b["float32"],
           bench_counts, times_b["float32"], list(times_b["float32"]))
    record(f"bench B={BENCH_BATCH} bf16", "bfloat16", errs_b["bfloat16"],
           bench_counts, times_b["bfloat16"], list(times_b["bfloat16"]))
    record("bench train", "float32", errs_d, bench_counts, times_d,
           ["depth_fill", "ball_query", "group_scatter", "three_nn",
            "interp_scatter"])

    # phases 37-38: the native host depth fill, the checkpoint converter
    seconds = {}
    clocked("37 native fill", phase_native_fill, device)
    convert_counts = clocked("38 converter", phase_convert, device)
    print("[phases 37-38] " + ", ".join(f"{k} {v:.1f} s"
                                         for k, v in seconds.items()))
    record("converted weights", "float32", errs, convert_counts, times,
           list(cases))

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": device_info}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--torchrun-train"]:
        torchrun_train_child(sys.argv[2], sys.argv[3:])
        sys.exit(0)
    sys.exit(main())
