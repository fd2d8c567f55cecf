from .segment_agg import (kernel_launch_count, reset_kernel_launch_count,
                          segment_mean_op)

__all__ = ["segment_mean_op", "kernel_launch_count",
           "reset_kernel_launch_count"]
