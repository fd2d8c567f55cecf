# The wrappers flash_attention, rmsnorm and add_rmsnorm live in ``ops`` (and
# in the modules flash_attention and rmsnorm, which an export here would
# shadow).
from .flash_attention import flash_launch_count, reset_flash_launch_count
from .rmsnorm import (add_rmsnorm_bwd_launch_count, add_rmsnorm_launch_count,
                      reset_rmsnorm_launch_count, rmsnorm_bwd_launch_count,
                      rmsnorm_launch_count)
from .segment_agg import (bwd_kernel_launch_count, kernel_launch_count,
                          reset_kernel_launch_count, segment_mean_bwd_op,
                          segment_mean_op)

__all__ = ["segment_mean_op", "segment_mean_bwd_op", "kernel_launch_count",
           "bwd_kernel_launch_count", "reset_kernel_launch_count",
           "flash_launch_count", "reset_flash_launch_count",
           "rmsnorm_launch_count", "add_rmsnorm_launch_count",
           "rmsnorm_bwd_launch_count", "add_rmsnorm_bwd_launch_count",
           "reset_rmsnorm_launch_count"]
