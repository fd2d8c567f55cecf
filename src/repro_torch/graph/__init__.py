from .csr import CSRGraph
from .synthetic import SyntheticSpec, make_benchmark, BENCHMARKS
from .sage import GraphSAGE, SAGELayer
from .distributed import (PartitionedGraph, RecomputePlanner,
                          build_partitioned_graph, make_distributed_forward,
                          make_export_forward, make_kernel_mean_agg,
                          make_ref_mean_agg)
from .featstore import (FeatureBudgetError, GlobalFeatStore,
                        PartitionFeatStore, assemble_features,
                        build_global_feat_store, build_partition_feat_store,
                        check_feat_budget, feat_peak_bytes,
                        reconstruct_features)

__all__ = [
    "CSRGraph", "SyntheticSpec", "make_benchmark", "BENCHMARKS",
    "GraphSAGE", "SAGELayer", "PartitionedGraph", "RecomputePlanner",
    "build_partitioned_graph", "make_distributed_forward",
    "make_export_forward", "make_kernel_mean_agg", "make_ref_mean_agg",
    "FeatureBudgetError", "GlobalFeatStore", "PartitionFeatStore",
    "assemble_features", "build_global_feat_store",
    "build_partition_feat_store", "check_feat_budget", "feat_peak_bytes",
    "reconstruct_features",
]
