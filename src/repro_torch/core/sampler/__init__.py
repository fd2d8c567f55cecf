# The host-side class-balanced sampler; the reference's on-device sampler
# (async paths) is not ported yet (ROADMAP item 9).
from .cbs import (CBSampler, cbs_probabilities, host_draw_count,
                  reset_host_draw_count)

__all__ = ["CBSampler", "cbs_probabilities", "host_draw_count",
           "reset_host_draw_count"]
