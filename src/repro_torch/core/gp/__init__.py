from .schedule import EarlyStopper, GPController, GPScheduleConfig, loss_flattened
from .trainer import (GPHyperParams, broadcast_to_partitions,
                      grad_sync_wire_bytes, make_fullgraph_loss_fn,
                      make_generalize_step, make_personalize_partition_step,
                      make_personalize_step)

__all__ = [
    "EarlyStopper", "GPController", "GPScheduleConfig", "loss_flattened",
    "GPHyperParams", "broadcast_to_partitions", "grad_sync_wire_bytes",
    "make_fullgraph_loss_fn", "make_generalize_step", "make_personalize_step",
    "make_personalize_partition_step",
]
