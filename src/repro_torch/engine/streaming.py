"""Partition-group streamed evaluation for the two-tier feature store
(counterpart of ``repro/engine/streaming.py``).

With ``feat_groups = G`` the stacked engine never assembles all P
``(max_nodes, D)`` feature planes at once: the eval runs as a host loop that
stages each partition's cold rows and assembles its plane only while that
partition's group is processed.  Only layer 1 reads the raw feature
planes, so the streaming is a two-pass schedule over that layer:

  pass A   per group: assemble the group's planes, keep only each plane's
           ``(P, maxS, D)`` halo SEND rows, drop the planes;
  pass B   per group: re-assemble (the cold rows are staged a second time,
           the trade of residency for traffic, counted), land the halo rows
           from the kept send rows, run layer 1 down to hidden width, drop
           the plane.

Layers >= 2 are hidden-width and run over all P partitions with the plain
explicit exchange.  The ops are the sequential oracle's
(:class:`~repro_torch.engine.sequential.SequentialReference`) in its order,
one partition at a time, so with the plain aggregation the streamed eval is
bitwise the oracle's.  With the kernels each partition's aggregation is ONE
launch of the segment forward kernel over that partition's own blocks and
work plan (:func:`~repro_torch.engine.stacking.partition_blocks`, built once
here): 2·P launches an eval at two layers.

Peak feature bytes: ``P*H*D*B + G*C*D*B + G*maxN*D*B``
(:func:`repro_torch.graph.featstore.feat_peak_bytes` with ``groups=G``),
which is what lets a graph whose stacked plane is over the budget evaluate.
"""
from __future__ import annotations

import torch

from ..graph.distributed import make_ref_mean_agg
from ..graph.featstore import assemble_features
from ..graph.sage import take_partition
from ..kernels.segment_agg import blocks_to_device, segment_mean_op
from .stacking import partition_blocks

__all__ = ["StreamedEvaluator"]


class StreamedEvaluator:
    """The streamed eval of an engine built with ``feat_groups``.

    ``blocks`` is the engine's stacked host blocks dict when it aggregates
    with the kernels (each partition gets its own unstacked blocks and plan
    on the device), else None (the plain aggregation over each partition's
    edge lists)."""

    def __init__(self, engine, blocks: dict | None = None):
        self.engine = engine
        P = engine.num_parts
        self._blk = None
        if blocks is not None:
            self._blk = [blocks_to_device(partition_blocks(blocks, p),
                                          engine.device) for p in range(P)]
        else:
            self._ref_agg = make_ref_mean_agg(engine.max_nodes)
            self._edges = [{k: engine.shards[k][p:p + 1] for k in (
                "edge_src", "edge_dst", "edge_mask")} for p in range(P)]

    # ---------------------------------------------------------- primitives
    def _assemble(self, p: int) -> torch.Tensor:
        """Partition p's full feature plane, its cold rows staged now."""
        eng = self.engine
        return assemble_features(
            eng.shards["fs_hot"][p], eng.shards["fs_rows_hot"][p],
            eng._stage(eng._cold_host[p]), eng.shards["fs_rows_cold"][p],
            eng.max_nodes)

    def _send(self, h: torch.Tensor, p: int) -> torch.Tensor:
        """Partition p's masked send rows ``(P, maxS, D)``."""
        sh = self.engine.shards
        return h[sh["send_idx"][p]] * sh["send_mask"][p][..., None]

    def _land(self, h: torch.Tensor, sent: list, q: int) -> torch.Tensor:
        """``h`` with partition q's received rows scattered into its halo
        slots (a new tensor)."""
        recv = torch.stack([s[q] for s in sent])
        d = h.shape[-1]
        return h.index_put((self.engine.shards["recv_pos"][q].reshape(-1),),
                           recv.reshape(-1, d).to(h.dtype))

    def _agg(self, h: torch.Tensor, p: int) -> torch.Tensor:
        if self._blk is not None:
            return segment_mean_op(h, self._blk[p],
                                   num_rows=self.engine.max_nodes).to(h.dtype)
        return self._ref_agg(h[None], self._edges[p])[0]

    def _layer(self, h: torch.Tensor, lp, p: int, activate: bool):
        out = h @ lp.w_self + self._agg(h, p) @ lp.w_neigh + lp.b
        return torch.relu(out) if activate else out

    # ------------------------------------------------------------- the eval
    @torch.no_grad()
    def forward(self, params, per_partition_params: bool) -> list:
        """The streamed eval forward: one ``(maxN, C)`` logits tensor per
        partition.  The cold rows it stages (2·P·C·D·B bytes) are counted
        in the engine's ``cold_h2d_bytes``."""
        eng = self.engine
        P, G = eng.num_parts, int(eng.config.feat_groups)
        plist = ([take_partition(params, p) for p in range(P)]
                 if per_partition_params else [params] * P)
        num_layers = len(plist[0].layers)
        groups = [range(g0, min(g0 + G, P)) for g0 in range(0, P, G)]

        # pass A: layer-1 send rows from transiently assembled planes
        sent = [None] * P
        for group in groups:
            for p in group:
                sent[p] = self._send(self._assemble(p), p)
        # pass B: re-assemble per group, land the halo rows, layer 1
        hs = [None] * P
        for group in groups:
            for q in group:
                h = self._land(self._assemble(q), sent, q)
                hs[q] = self._layer(h, plist[q].layers[0], q, num_layers > 1)
        del sent
        # hidden-width layers: all partitions resident, the plain schedule
        for i in range(1, num_layers):
            sent = [self._send(hs[p], p) for p in range(P)]
            hs = [self._land(hs[q], sent, q) for q in range(P)]
            hs = [self._layer(hs[p], plist[p].layers[i], p,
                              i < num_layers - 1) for p in range(P)]
        return hs

    def evaluate(self, params, split: str, per_partition_params: bool):
        """``(micro (P,), preds (P, maxN))`` of one streamed eval."""
        hs = self.forward(params, per_partition_params)
        preds = torch.stack([torch.argmax(h, dim=-1) for h in hs])
        return self.engine._micro(preds, split), preds
