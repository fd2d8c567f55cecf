from .segment_agg import (bwd_kernel_launch_count, kernel_launch_count,
                          reset_kernel_launch_count, segment_mean_bwd_op,
                          segment_mean_op)

__all__ = ["segment_mean_op", "segment_mean_bwd_op", "kernel_launch_count",
           "bwd_kernel_launch_count", "reset_kernel_launch_count"]
