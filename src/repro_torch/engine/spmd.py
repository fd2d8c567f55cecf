"""Stacked execution engine (counterpart of ``repro/engine/spmd.py``).

On one GPU all P partitions run batched on one device: every shard array
is stacked into a ``(P, ...)`` tensor and each forward is one program over
all partitions, the reference's ``mode="stacked"``.  This slice ports the
engine's construction (shards and blocked-CSR structures) and
:meth:`SPMDEngine.export_serving_state`, the full-graph forward every
validation and test evaluation also runs.  The training methods join with
the training slice (ROADMAP items 5–7); every other ``EngineConfig`` option
raises ``NotImplementedError`` naming the ROADMAP item that ports it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..graph.distributed import (PartitionedGraph, make_distributed_forward,
                                 make_export_forward, make_kernel_mean_agg,
                                 make_ref_mean_agg)
from ..kernels.segment_agg import blocks_to_device
from .stacking import build_stacked_vjp_blocks

__all__ = ["EngineConfig", "SPMDEngine"]


@dataclass(frozen=True)
class EngineConfig:
    mode: str = "stacked"           # stacked (spmd, sequential: not yet)
    # route the full-graph aggregation through the CUDA segment-mean kernel
    # (counterpart of the reference's ``use_pallas_agg``); False uses the
    # plain index_add_ aggregation
    use_kernel_agg: bool = True
    dtype: torch.dtype = torch.float32   # float dtype of graph features
    device: str = "cuda"            # raises without a card unless "cpu"
    # options of the reference engine that are not ported yet: a value
    # other than the default raises NotImplementedError
    overlap_halo: bool = False
    halo_cache: bool = False
    halo_compress: str = "none"
    grad_compress: str = "none"
    feat_store: bool = False
    feat_groups: int = 0


# option -> (default, ROADMAP item that ports it)
_NOT_PORTED = {"overlap_halo": (False, 8), "halo_cache": (False, 10),
               "halo_compress": ("none", 10), "grad_compress": ("none", 10),
               "feat_store": (False, 11), "feat_groups": (0, 11)}
_MODE_ITEMS = {"spmd": 14, "auto": 14, "sequential": 5}


def _check_config(config: EngineConfig) -> None:
    if config.mode != "stacked":
        item = _MODE_ITEMS.get(config.mode)
        if item is None:
            raise ValueError(f"unknown engine mode {config.mode!r}")
        raise NotImplementedError(
            f"mode={config.mode!r} is not ported yet (ROADMAP item {item}); "
            "use mode='stacked'")
    for name, (default, item) in _NOT_PORTED.items():
        if getattr(config, name) != default:
            raise NotImplementedError(
                f"EngineConfig.{name}={getattr(config, name)!r} is not ported "
                f"yet (ROADMAP item {item})")


class SPMDEngine:
    """Stacked executor over a :class:`PartitionedGraph`.

    The constructor keeps the reference's argument order ``(model, loss_fn,
    optimizer, pg, hp, config)``; this slice reads only ``model``, ``pg``
    and ``config`` (serving passes ``None`` for the training arguments).
    """

    def __init__(self, model, loss_fn, optimizer, pg: PartitionedGraph,
                 hp=None, config: EngineConfig = EngineConfig()):
        _check_config(config)
        self.model = model
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.hp = hp
        self.config = config
        self.mode = config.mode
        self.device = resolve_device(config.device)
        # float32 products stay full float32 on the card, as the reference's
        # XLA dots are: no TF32 for matmuls (nor for cuDNN, which this
        # engine does not call)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.num_parts = pg.num_parts
        self.num_classes = model.num_classes
        self.max_nodes = pg.max_nodes

        f, dev = config.dtype, self.device
        idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
        flt = lambda a: torch.as_tensor(np.asarray(a), dtype=f, device=dev)
        self.shards = {
            "send_idx": idx(pg.send_idx),
            "send_mask": flt(pg.send_mask),
            "recv_pos": idx(pg.recv_pos),
            "features": flt(pg.features),
            "edge_src": idx(pg.edge_src),
            "edge_dst": idx(pg.edge_dst),
            "edge_mask": flt(pg.edge_mask),
        }
        if config.use_kernel_agg:
            # the kernel reads float32 masks/degrees whatever the features'
            # dtype (both hold small integers, exact in every float type)
            self.shards["blk"] = blocks_to_device(
                build_stacked_vjp_blocks(pg), dev)

        meta = {"max_nodes": pg.max_nodes, "own_cap": pg.own_cap}
        self._fwd_meta = meta
        self._mean_agg = (make_kernel_mean_agg(pg.max_nodes)
                          if config.use_kernel_agg
                          else make_ref_mean_agg(pg.max_nodes))
        self.fwd = make_distributed_forward(model, meta, agg=self._mean_agg)

    @torch.no_grad()
    def export_serving_state(self, params) -> dict:
        """One full forward materializing the serving handoff:
        ``{"layers": [(P, maxN, D_i) per layer], "logits": (P, maxN, C),
        "cache": {"h{i}": (P, P, maxS, D_i)}}``.  The reference returns
        host numpy arrays; here they stay tensors on the engine's device,
        where the serving engine keeps its stores.  ``params`` is a
        ``GraphSAGE`` on that device (global, replicated weights)."""
        fwd_e = make_export_forward(self.model, self._fwd_meta,
                                    agg=self._mean_agg)
        return fwd_e(params, self.shards)
