# Host-side (NumPy) half of the paper's contribution: label-entropy metrics
# and entropy-aware (EW) partitioning.  The class-balanced sampler and the
# generalize-then-personalize trainer join with the training slice.
from .entropy import PartitionStats, label_entropy, partition_entropies, partition_stats
from .partition import PartitionResult, assign_edge_weights, metis_kway, partition_graph

__all__ = [
    "label_entropy", "partition_entropies", "partition_stats", "PartitionStats",
    "partition_graph", "PartitionResult", "assign_edge_weights", "metis_kway",
]
