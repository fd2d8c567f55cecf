from .api import PartitionResult, partition_graph
from .edge_weights import assign_edge_weights
from .metis import metis_kway

__all__ = ["partition_graph", "PartitionResult", "assign_edge_weights", "metis_kway"]
