"""Weight bridge from the JAX package's variables to the port's state dict.

The port's submodules carry the reference torch key names
(``tests/data/ref_torch_keys.json``), so the bridge is the JAX package's own
exporter ``istnet_tpu.cli.convert_torch_istnet.export_state_dict``, which
needs only numpy. It folds the JAX SharedMLP's dense bias (which torch's
bias-free conv lacks) into the BN running mean, exact at eval in float32,
and fills the dead ``feats.fc`` weights with zeros. A reference model-zoo
``.pth`` state dict loads into the port directly, with no bridge.

Under the bf16 policy the fold is one rounding away from JAX on the layers
that run unfused (SA stage 1 and the FP MLPs): JAX rounds ``x @ W + b`` to
bf16 before its BN, the port rounds ``x @ W`` and subtracts the folded mean
in its float32 BN, inside the bf16 tolerance. The fused SA stages fold BN
at call time from these same values (``nn/pointnet2_msg.py::
_fold_shared_mlp``), where ``b - mean`` is the exact negation of the
bridged running mean, as in JAX.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _numpy_tree(tree):
    if isinstance(tree, Mapping):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def state_dict_from_jax(variables: Mapping, model: str = "ist_net"
                        ) -> dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` trees of the JAX ``ISTNet``
    (numpy or JAX arrays) -> the port's ``state_dict``, for
    ``load_state_dict(strict=True)``."""
    # imported here: the exporter lives in the JAX package, which the port
    # otherwise never imports (the module itself imports numpy only)
    from istnet_tpu.cli.convert_torch_istnet import export_state_dict

    trees = {"params": _numpy_tree(variables["params"]),
             "batch_stats": _numpy_tree(variables["batch_stats"])}
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in export_state_dict(trees, model).items()}
