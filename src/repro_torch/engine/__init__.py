from .spmd import EngineConfig, SPMDEngine
from .stacking import build_stacked_vjp_blocks

__all__ = ["EngineConfig", "SPMDEngine", "build_stacked_vjp_blocks"]
