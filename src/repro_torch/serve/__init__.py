from .gnn import GNNServingEngine, apply_updates_to_graph

__all__ = ["GNNServingEngine", "apply_updates_to_graph"]
