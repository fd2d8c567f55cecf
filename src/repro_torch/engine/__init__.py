from .sequential import SequentialReference
from .spmd import EngineConfig, SPMDEngine
from .stacking import (build_stacked_feat_store,
                       build_stacked_split_vjp_blocks,
                       build_stacked_vjp_blocks, partition_blocks,
                       partition_vjp_blocks)
from .streaming import StreamedEvaluator

__all__ = ["EngineConfig", "SPMDEngine", "SequentialReference",
           "StreamedEvaluator", "build_stacked_vjp_blocks",
           "build_stacked_split_vjp_blocks", "build_stacked_feat_store",
           "partition_blocks", "partition_vjp_blocks", "make_engine"]


def make_engine(model, loss_fn, optimizer, pg, hp=None, config=None):
    """Mode-dispatching factory: ``mode="sequential"`` gives the Python-loop
    oracle :class:`SequentialReference`, anything else :class:`SPMDEngine`,
    which runs ``stacked`` and ``spmd`` (this rank's partition of the mesh,
    inside a ``torch.distributed`` world of P ranks) and resolves ``auto``
    itself."""
    from ..core.gp.trainer import GPHyperParams

    hp = hp if hp is not None else GPHyperParams()
    config = config if config is not None else EngineConfig()
    if config.mode == "sequential":
        return SequentialReference(model, loss_fn, optimizer, pg, hp, config)
    return SPMDEngine(model, loss_fn, optimizer, pg, hp, config)
