"""Compute-dtype policy (counterpart of ``istnet_tpu/nn/precision.py``).

Two policies, as in the JAX package:

- float32 (the default; ``config/ist_net_default.yaml: compute_dtype:
  float32``);
- bfloat16, the deployment precision ``bench.py`` sets: convs and dense
  layers run in bf16 with float32 parameters cast on each call; BatchNorm
  arithmetic, the geometry (FPS, ball query, 3-NN distances) and the pose
  and NOCS head outputs stay float32. Only this policy's eval forward takes
  the fused SA kernel (``nn/pointnet2_msg.py``).

float64 is accepted too, for the parity tests on the CPU only, as the JAX
package's tests run its float64 policy under x64: the model is then
``.double()``, values stay float64, and what JAX keeps float32 under that
policy stays float32 here too (the geometry's decisions, the pose and NOCS
head outputs and the losses). No kernel takes float64.

The policy is read when a module runs (JAX reads it when it traces), so set
it before a forward and restore it after, as the tests do:

    from istnet_tpu_torch.nn import precision
    precision.set_compute_dtype(torch.bfloat16)

``apply_policy`` sets the backend flags: TF32 stays off under both policies
(PyTorch runs float32 convolutions through cuDNN in TF32 by default, which
keeps only about three decimal digits), and under bf16 cuBLAS must not
reduce bf16 GEMM partial sums in bf16
(``allow_bf16_reduced_precision_reduction`` defaults to True): JAX
accumulates bf16 products in float32.
"""

from __future__ import annotations

import torch

_COMPUTE_DTYPE = torch.float32
_POLICIES = (torch.float32, torch.bfloat16, torch.float64)


def set_compute_dtype(dtype: torch.dtype) -> None:
    global _COMPUTE_DTYPE
    if dtype not in _POLICIES:
        raise ValueError(f"compute dtype {dtype}: float32 or bfloat16 "
                         f"(float64 in the CPU parity tests)")
    _COMPUTE_DTYPE = dtype


def compute_dtype() -> torch.dtype:
    return _COMPUTE_DTYPE


def apply_policy() -> None:
    """Set the backend flags the policy needs. Call before running a model
    on the card (``ISTNet.forward`` does)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if _COMPUTE_DTYPE == torch.bfloat16:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
