# The host-side class-balanced sampler and the on-device epoch sampler of
# the async paths.
from .cbs import (CBSampler, cbs_probabilities, host_draw_count,
                  reset_host_draw_count)
from .cbs_device import (DeviceEpochSampler, build_device_epoch_sampler,
                         cbs_probabilities_device, device_draw_count,
                         device_fanout, eq3_column_norms, gumbel_subset,
                         reset_device_draw_count)

__all__ = ["CBSampler", "cbs_probabilities", "host_draw_count",
           "reset_host_draw_count", "DeviceEpochSampler",
           "build_device_epoch_sampler", "cbs_probabilities_device",
           "device_draw_count", "device_fanout", "eq3_column_norms",
           "gumbel_subset", "reset_device_draw_count"]
