"""Data parallelism across processes, one a device (counterpart of
``istnet_tpu/parallel``): the process group (``multihost``), the
differentiable all-reduce (``collectives``), DDP with global-batch
BatchNorm and the data-parallel eval forward (``mesh``)."""

from istnet_tpu_torch.parallel.collectives import (all_reduce_mean,
                                                   all_reduce_sum)
from istnet_tpu_torch.parallel.mesh import (
    FSDP_NOT_YET,
    eval_forward_dp,
    fsdp_shardings,
    jit_train_step_fsdp,
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
    "FSDP_NOT_YET", "all_reduce_mean", "all_reduce_sum",
    "eval_forward_dp", "fsdp_shardings", "jit_train_step_fsdp",
    "make_mesh_2d", "replicate", "set_batch_norm_group", "shard_batch",
    "shard_batch_2d", "shard_state_fsdp", "state_shardings_fsdp", "unwrap",
    "wrap_dp",
]
