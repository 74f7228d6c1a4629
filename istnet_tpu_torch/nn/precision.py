"""Compute-dtype policy (counterpart of ``istnet_tpu/nn/precision.py``).

This slice of the port supports the float32 policy only, the default of the
JAX package (``config/ist_net_default.yaml: compute_dtype: float32``). The
bf16 policy comes with the fused SA kernel.

float32 here means true float32 on the card: PyTorch runs float32
convolutions through cuDNN in TF32 by default (``torch.backends.cudnn
.allow_tf32`` is True), which keeps only about three decimal digits. Under
the float32 policy ``apply_policy`` turns TF32 off for both cuBLAS matmuls
and cuDNN convolutions. TF32 is a later, measured choice.
"""

from __future__ import annotations

import torch


def apply_policy() -> None:
    """Set the backend flags the policy needs. Call before running a model
    on the card (``ISTNet.forward`` does)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
