"""Point-cloud ops, the fused SA stage, the fold-upsample conv, the depth
completion and the eval BatchNorm pass, each a
hand-written CUDA kernel on CUDA tensors and its plain PyTorch version on
CPU tensors (``dispatch.py``; the BN pass is ``dispatch.bn_eval``, beside
its module ``ops.bn_eval``)."""

from istnet_tpu_torch.ops.dispatch import (  # noqa: F401
    ball_query_group,
    fill_in_multiscale,
    fold_upsample_conv,
    fp_interpolate,
    furthest_point_sample,
    launch_counts,
    reset_launch_counts,
    sa_msg_fused,
)
from istnet_tpu_torch.ops.pointnet2 import gather_points  # noqa: F401
