"""Data parallelism across processes, one a device (counterpart of
``istnet_tpu/parallel``): the process group (``multihost``), the
differentiable all-reduce (``collectives``), DDP with global-batch
BatchNorm, the data-parallel eval forward and FSDP over a 2-D ``(dp,
fsdp)`` mesh (``mesh``).

JAX's ``jit_train_step_fsdp`` has no counterpart: there is no ``jit`` to
give shardings to. ``shard_state_fsdp`` shards the model once, and the
plain ``train.train_state.train_step`` on it is the FSDP step."""

from istnet_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                   all_reduce_sum)
from istnet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FSDP_AXIS,
    eval_forward_dp,
    fsdp_shardings,
    is_sharded,
    make_mesh_2d,
    replicate,
    set_batch_norm_group,
    shard_batch,
    shard_batch_2d,
    shard_state_fsdp,
    state_shardings_fsdp,
    unwrap,
    wrap_dp,
)

__all__ = [
    "DATA_AXIS", "FSDP_AXIS", "all_reduce_mean", "all_reduce_sum",
    "eval_forward_dp", "fsdp_shardings", "is_sharded",
    "make_mesh_2d", "replicate", "set_batch_norm_group", "shard_batch",
    "shard_batch_2d", "shard_state_fsdp", "state_shardings_fsdp", "unwrap",
    "wrap_dp",
]
