from .engine import ServeEngine
from .gnn import GNNServingEngine, apply_updates_to_graph

__all__ = ["ServeEngine", "GNNServingEngine", "apply_updates_to_graph"]
