# The paper's contribution: label-entropy metrics and entropy-aware (EW)
# partitioning (host NumPy), the class-balanced sampler (CBS) and the
# generalize-then-personalize (GP) schedule and train steps.
from .entropy import PartitionStats, label_entropy, partition_entropies, partition_stats
from .partition import PartitionResult, assign_edge_weights, metis_kway, partition_graph
from .sampler import CBSampler, cbs_probabilities
from .gp import (EarlyStopper, GPController, GPHyperParams, GPScheduleConfig,
                 broadcast_to_partitions, loss_flattened,
                 make_fullgraph_loss_fn, make_generalize_step,
                 make_personalize_step)

__all__ = [
    "label_entropy", "partition_entropies", "partition_stats", "PartitionStats",
    "partition_graph", "PartitionResult", "assign_edge_weights", "metis_kway",
    "CBSampler", "cbs_probabilities",
    "GPController", "GPScheduleConfig", "GPHyperParams", "EarlyStopper",
    "loss_flattened", "make_fullgraph_loss_fn", "make_generalize_step",
    "make_personalize_step", "broadcast_to_partitions",
]
