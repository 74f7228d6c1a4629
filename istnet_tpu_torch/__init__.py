"""IST-Net category-level 6D pose estimation on PyTorch + hand-written CUDA.

A port of ``istnet_tpu`` (the JAX/TPU package, which stays the reference) to
PyTorch on an NVIDIA H100. Module names mirror the JAX package: ``nn/`` holds
the layers and sub-networks, ``ops/`` the point-cloud ops with their CUDA
kernels (sources in ``csrc/``), ``models/`` the top-level ``ISTNet``.

Public functions keep the JAX layout: channel-last ``(B, N, C)`` points and
NHWC images. This package imports ``torch`` and never ``jax``.
"""
